"""Entry ``generate_images``: the program's text-to-image call over a batch
of prompts a request (``pipeline.generate_images``); the reference's
``txt2img`` for one image of a request; the operations a request needs."""

from port_bench import flops


def serve(server):
    """-> call(request) -> uint8 images (B, H, W, 3) on the host."""
    port = server.port

    def call(req):
        return port.generate_images(
            req["prompts"], req["uncond"], models=server.models, tokenizer=server.tok,
            config=server.config, height=req["height"], width=req["width"], seed=req["seed"],
            sampler_name=req["sampler"], n_inference_steps=req["steps"],
            timestep_spacing=req["spacing"], cfg_scale=req["cfg_scale"])

    return call


def reference(ref, req, j):
    """Image ``j`` of ``req`` by the plain reference."""
    return ref.txt2img(prompt=req["prompts"][j], uncond=req["uncond"], seed=req["seed"],
                       index=j, height=req["height"], width=req["width"],
                       sampler=req["sampler"], steps=req["steps"], spacing=req["spacing"],
                       cfg_scale=req["cfg_scale"])


def request_flops(model, mix):
    """The towers over the cond and uncond prompts, every UNet evaluation
    at its CFG batch, the decode."""
    b = mix["batch"]
    return flops.pass_flops(model, b, mix["height"], mix["width"], mix["steps"]) \
        + flops.decode_flops(model, b, mix["height"], mix["width"])
