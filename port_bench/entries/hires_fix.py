"""Entry ``hires_fix``: the program's ``StableDiffusion.hires_fix``, one
prompt a request (a pass at the base size, the latents upscaled, a second
pass at ``strength`` at the full size, the decode); the reference's
``hires_fix``; the operations a request needs."""

from port_bench import flops


def serve(server):
    """-> call(request) -> uint8 images (1, H, W, 3) on the host."""
    sd = server.port.StableDiffusion(server.models, server.tok, server.config,
                                     device=server.device)

    def call(req):
        image = sd.hires_fix(req["prompts"][0], req["uncond"], height=req["height"],
                             width=req["width"], base_height=req["base_height"],
                             base_width=req["base_width"], strength=req["strength"],
                             upscale_method=req["upscale_method"], seed=req["seed"],
                             sampler_name=req["sampler"], n_inference_steps=req["steps"],
                             timestep_spacing=req["spacing"], cfg_scale=req["cfg_scale"])
        return image[None]

    return call


def reference(ref, req, j):
    """Image ``j`` of ``req`` by the plain reference (bilinear upscale)."""
    if req["upscale_method"] != "bilinear":
        raise ValueError(f"the reference upscales bilinearly, not {req['upscale_method']!r}")
    return ref.hires_fix(prompt=req["prompts"][j], uncond=req["uncond"], seed=req["seed"],
                         index=j, height=req["height"], width=req["width"],
                         base_height=req["base_height"], base_width=req["base_width"],
                         strength=req["strength"], sampler=req["sampler"],
                         steps=req["steps"], spacing=req["spacing"],
                         cfg_scale=req["cfg_scale"])


def request_flops(model, mix):
    """Both passes (the second from step ``steps - int(steps · strength)``)
    and the decode at the full size."""
    b, steps = mix["batch"], mix["steps"]
    start = steps - int(steps * mix["strength"])
    return flops.pass_flops(model, b, mix["base_height"], mix["base_width"], steps) \
        + flops.pass_flops(model, b, mix["height"], mix["width"], steps, start) \
        + flops.decode_flops(model, b, mix["height"], mix["width"])
