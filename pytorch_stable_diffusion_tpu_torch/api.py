"""High-level API (port of ``api.py``): one object holding the models,
tokenizer and config, for repeated generation.

``StableDiffusion`` runs on the card unless ``device=`` names another
device (the CPU tests pass ``"cpu"``); without a card and without
``device=`` it raises.  The ``with_*`` methods (``with_lora``, ``with_vae``,
``merged_with``, ``with_hypernetwork``, ``with_textual_inversion``, and
slice E's ``with_controlnet``, ``with_t2i_adapter`` and
``with_ip_adapter``, AnimateDiff's ``with_motion`` and the ESRGAN's
``with_upscaler``) return new bundles and leave the original as it was;
their models share every parameter the transform leaves unchanged.
``mesh=`` (slice H2, ``core/mesh.py``; one process a rank, every rank
making the same calls): where the mesh's model axis is > 1 each request
runs on the models sharded over it (``parallel/tp.shard_models``), else
on the models themselves, checked equal across the data ranks
(``parallel/dp.replicate_params``); the batch is split over the data axis.
The bundle keeps the whole models, which the ``with_*`` methods
transform.  The workloads: ``animate`` (AnimateDiff clips, frame
windows past the modules' trained length), ``upscale`` (ESRGAN, whole or
tiled), ``hires_fix(upscale_method="esrgan")`` and ``sd_upscale`` (A1111's
tiled img2img upscale); panoramas are ``txt2img(panorama=True, ...)``.
The generation methods pass every keyword through to ``generate()``,
slice F's modes too; :func:`fast_preset` gives the
approximate-mode bundle: ``cfg, kw = fast_preset(sd.config)``, then
``StableDiffusion(sd.models, sd.tokenizer, cfg).txt2img(prompt, **kw)``.

The JAX package's top-level loaders are here too: :func:`load_models`,
:func:`load_diffusers_models` and :func:`load_models_streamed` read a file
or a diffusers directory into the models dict ``generate(models=)`` takes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import pipeline as pipeline_mod
from .models import assemble, target_device
from .models.config import SDConfig, fast_preset, sd15_config  # noqa: F401 (exported)
from .weights.convert import load_sd_checkpoint
from .weights.tokenizer import CLIPTokenizer


def _to_rgb_float(image) -> np.ndarray:
    """Any image input -> (H, W, 3) float32 in 0..255 (grayscale stacked,
    alpha dropped, [0, 1]-ranged FLOAT inputs rescaled — integer inputs
    are always 0..255 already; a near-black uint8 image whose max pixel
    is 1 must NOT be blown up to white)."""
    arr = np.asarray(image)
    is_float = arr.dtype.kind == "f"
    img = arr.astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[..., :3]
    if is_float and img.max() <= 1.0:
        img = img * 255.0
    return img


def _mask_array(mask_image) -> np.ndarray:
    """A PIL or array mask -> (H, W) float32, 0..255 inputs scaled to [0, 1]."""
    m = np.asarray(mask_image.convert("L") if hasattr(mask_image, "convert")
                   else mask_image, np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    if m.max() > 1.0:
        m = m / 255.0
    return m


def _as_models(cfg: SDConfig, device: torch.device, state_dicts):
    """Port state dicts (CPU tensors of any dtype) -> models on ``device``
    in the policy's dtype, with no second copy."""
    dtype = cfg.policy.param_dtype
    return assemble(cfg, {name: {k: v.to(device=device, dtype=dtype) for k, v in sd.items()}
                          for name, sd in state_dicts.items()})


def _stored_as(cfg: Optional[SDConfig], dtype) -> SDConfig:
    """``cfg`` (SD-1.5 when None) with its weights stored in ``dtype`` (the
    policy's ``param_dtype`` when None); the modules cast each weight to
    the policy's compute dtype where they use it."""
    cfg = cfg or sd15_config()
    if dtype is None or dtype == cfg.policy.param_dtype:
        return cfg
    return dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy, param_dtype=dtype))


def load_models(path: str, cfg: Optional[SDConfig] = None, dtype=None, *,
                allow_unsafe_fallback: bool = False, device=None):
    """A CompVis checkpoint file (``.safetensors`` or ``.ckpt``) -> the
    models dict ``generate(models=)`` takes: the JAX package's top-level
    ``load_models`` (its ``weights/convert.load_sd_checkpoint``), with
    models in place of parameter trees.  ``cfg`` is the family (SD-1.5
    when None); the weights are stored in ``dtype`` (by default the
    policy's ``param_dtype``) on the card unless ``device`` names another
    device."""
    cfg = _stored_as(cfg, dtype)
    return _as_models(cfg, target_device(device, "load_models"), load_sd_checkpoint(
        path, cfg, allow_unsafe_fallback=allow_unsafe_fallback))


def load_diffusers_models(root: str, cfg: Optional[SDConfig] = None, dtype=None, *,
                          device=None):
    """A diffusers directory -> the models dict, as :func:`load_models`
    (the JAX package's ``load_diffusers_models``,
    ``weights/diffusers.load_diffusers_pipeline``)."""
    from .weights import diffusers

    cfg = _stored_as(cfg, dtype)
    return _as_models(cfg, target_device(device, "load_diffusers_models"),
                      diffusers.load_diffusers_pipeline(root, cfg))


def load_models_streamed(path: str, cfg: Optional[SDConfig] = None, dtype=None, *,
                         mesh=None, tp: bool = False, allow_unsafe_fallback: bool = False,
                         device=None):
    """A checkpoint file -> the models dict, read a tensor at a time
    straight onto the device (the JAX package's ``load_models_streamed``,
    ``weights/stream.load_sd_checkpoint_streamed``); with ``mesh`` and
    ``tp=True`` each rank holds the models sharded over the mesh's model
    axis, as ``generate(mesh=)`` takes them."""
    from .weights import stream

    cfg = _stored_as(cfg, dtype)
    state_dicts = stream.load_sd_checkpoint_streamed(
        path, cfg, device=target_device(device, "load_models_streamed"), mesh=mesh, tp=tp,
        allow_unsafe_fallback=allow_unsafe_fallback)
    if tp:
        from .parallel import tp as tp_mod

        return tp_mod.assemble(cfg, state_dicts, mesh)
    return assemble(cfg, state_dicts)


class StableDiffusion:
    """Loaded SD model bundle.

    Example::

        sd = StableDiffusion.from_checkpoint(
            "v1-5.safetensors", "vocab.json", "merges.txt",
            config=sd15_config(policy=BF16, attention_backend="kernel"))
        # SD-2.1 768-v: config=sd21_config(...); SDXL: sdxl_config(...),
        # and its refiner sdxl_refiner_config(...) over the base's latents:
        # refiner.txt2img(prompt, init_latents=latents, strength=0.3)
        image = sd.txt2img("a photo of a dog", seed=1337)
        image = sd.img2img("a cat", init_image, strength=0.8)
        images = sd.generate_many(["a dog"] * 8, seed=0, batch_size=4)
        # slice C3: inpaint (9-channel sd15_inpaint_config, or latent blend on
        # any other), outpaint, InstructPix2Pix (sd15_ip2p_config), hires fix
        image = sd.inpaint("a cat", init_image, mask, full_res=True)
        image = sd.hires_fix("a cat", height=1024, width=1024, strength=0.6)
    """

    def __init__(self, models, tokenizer, config: Optional[SDConfig] = None,
                 mesh=None, *, device=None):
        self.device = target_device(device, "StableDiffusion")
        self.config = config or sd15_config()
        for m in models.values():
            for net in m if isinstance(m, (list, tuple)) else [m]:
                net.to(self.device)
        self.models = models
        self.tokenizer = tokenizer
        self._hyper = None
        self._motion_max = None  # the motion modules' trained frame window
        self._upscaler = None  # the ESRGAN net of with_upscaler
        self.mesh = mesh
        self._place()

    def _place(self):
        """The models a request runs on: sharded over the mesh's model axis
        (TP), or the bundle's own, checked equal across the data ranks."""
        self._placed = self.models
        if self.mesh is None:
            return
        from .core.mesh import MODEL_AXIS, axis_size

        if axis_size(self.mesh, MODEL_AXIS) > 1:
            from .parallel.tp import shard_models

            self._placed = shard_models(self.models, self.mesh)
        else:
            from .parallel.dp import replicate_params

            replicate_params(self.models, self.mesh)

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, vocab_path: str, merges_path: str,
                        config: Optional[SDConfig] = None, mesh=None,
                        loras: Optional[Sequence] = None, *, device=None):
        """A CompVis checkpoint file (``.safetensors`` or ``.ckpt``) and the
        CLIP tokenizer's files.  ``loras``: adapters merged into the weights
        once loaded — each entry a path, or a ``(path, scale)`` pair."""
        config = config or sd15_config()
        dev = target_device(device, "StableDiffusion")
        models = load_models(ckpt_path, config, device=dev)
        if loras:
            from .weights import lora as lora_mod

            pairs = [(lora_mod.load_lora(x), 1.0) if isinstance(x, str)
                     else (lora_mod.load_lora(x[0]), float(x[1])) for x in loras]
            models = lora_mod.apply_loras(models, config, pairs)
        tokenizer = CLIPTokenizer.from_files(vocab_path, merges_path,
                                             max_len=config.clip.max_len)
        return cls(models, tokenizer, config, mesh, device=dev)

    # ------------------------------------------------------- with_* methods
    def _clone(self, *, models=None, tokenizer=None, config=None):
        """New bundle sharing this one's state, the attached hypernetwork
        included: every ``with_*`` method goes through here, so no active
        feature drops off a clone."""
        out = type(self).__new__(type(self))
        out.device = self.device
        out.models = self.models if models is None else models
        out.tokenizer = self.tokenizer if tokenizer is None else tokenizer
        out.config = self.config if config is None else config
        out._hyper = self._hyper
        out._motion_max = self._motion_max
        out._upscaler = self._upscaler
        out.mesh = self.mesh
        out._place()
        return out

    def with_lora(self, lora, scale: float = 1.0, *, strict: bool = True):
        """A bundle with a LoRA adapter merged in (``weights/lora.py``);
        ``lora`` is a file path or a LoRA state dict, ``scale`` the user
        strength multiplier."""
        from .weights import lora as lora_mod

        sd = lora_mod.load_lora(lora) if isinstance(lora, str) else lora
        return self._clone(models=lora_mod.apply_lora(self.models, self.config, sd, scale,
                                                      strict=strict))

    def with_vae(self, vae):
        """A bundle with a standalone VAE swapped in (the A1111 "SD VAE"
        override): a CompVis-layout ``.vae.pt``/``.ckpt``/``.safetensors``
        file, a diffusers ``vae/`` directory, or an ``(encoder, decoder)``
        pair of state dicts."""
        if isinstance(vae, str):
            from .weights.convert import load_vae

            vae = load_vae(vae, self.config)
        enc, dec = vae
        return self._clone(models=dict(self.models, **_as_models(
            self.config, self.device, {"encoder": enc, "decoder": dec})))

    def merged_with(self, other, alpha: float = 0.5, third=None):
        """A1111 checkpoint merger: the weighted sum of this bundle's weights
        and ``other``'s at ``alpha`` (0 = self, 1 = other), or the add-
        difference ``self + alpha·(other − third)`` when ``third`` is given.
        ``other``/``third`` may be bundles or models dicts."""
        from .weights.merge import merge_models

        def _models(x):
            return x.models if isinstance(x, StableDiffusion) else x

        merged = merge_models(self.models, _models(other), self.config, alpha,
                              None if third is None else _models(third))
        return self._clone(models=dict(self.models, **merged))

    def with_hypernetwork(self, hypernetwork, strength: float = 1.0):
        """A bundle with an A1111 hypernetwork active
        (``weights/hypernetwork.py``): small residual MLPs transform the
        cross-attention context, k and v apart, at every layer.
        ``hypernetwork`` is a ``.pt`` path or the loader's ``(module,
        (activation, activate_output))`` pair; ``strength`` is A1111's
        multiplier."""
        from .weights import hypernetwork as hyper_mod

        net, meta = hyper_mod.load_hypernetwork(hypernetwork) \
            if isinstance(hypernetwork, str) else hypernetwork
        out = self._clone(models=dict(self.models, hypernetwork=net.to(self.device)))
        out._hyper = (meta, float(strength))
        return out

    def with_textual_inversion(self, embedding, token: Optional[str] = None):
        """A bundle with a textual-inversion embedding installed
        (``weights/textual_inversion.py``): ``embedding`` is a ``.pt``/
        ``.safetensors`` path or a ready ``{trigger: (n, d)}`` dict (SDXL:
        ``{trigger: {"clip_l": (n, 768), "clip_g": (n, 1280)}}``, or the pair
        itself with ``token=``); ``token`` overrides the trigger word.  The
        trigger then works in any prompt: ``sd.txt2img("a photo of
        <my-style>")``."""
        from .weights import textual_inversion as ti

        if isinstance(embedding, str):
            embs = ti.load_embedding(embedding, token)
        elif ti.is_dual(embedding):
            if token is None:
                raise ValueError("a dual-tower embedding dict needs token=")
            embs = {token: embedding}
        else:
            embs = {token: embedding} if token is not None else dict(embedding)
        models, tok, cfg = ti.add_embeddings(self.models, self.tokenizer, self.config,
                                             embs)
        return self._clone(models=models, tokenizer=tok, config=cfg)

    # ---------------------------------------------------------- generation
    def _kw(self, kwargs):
        kwargs.setdefault("models", self._placed)
        kwargs.setdefault("tokenizer", self.tokenizer)
        if self.mesh is not None:
            kwargs.setdefault("mesh", self.mesh)
        kwargs.setdefault("config", self.config)
        kwargs.setdefault("device", self.device)
        if self._hyper is not None:
            kwargs.setdefault("hypernetwork", self._hyper[0])
            kwargs.setdefault("hypernetwork_strength", self._hyper[1])
        return kwargs

    def txt2img(self, prompt: str, uncond_prompt: str = "", **kwargs) -> np.ndarray:
        return pipeline_mod.generate(prompt, uncond_prompt, **self._kw(kwargs))

    def img2img(self, prompt: str, init_image, strength: float = 0.8,
                uncond_prompt: str = "", **kwargs) -> np.ndarray:
        return pipeline_mod.generate(prompt, uncond_prompt, input_image=init_image,
                                     strength=strength, **self._kw(kwargs))

    def generate_batch(self, prompts: Sequence[str], uncond_prompts="",
                       **kwargs) -> np.ndarray:
        return pipeline_mod.generate_images(list(prompts), uncond_prompts,
                                            **self._kw(kwargs))

    def generate_many(self, prompts: Sequence[str], uncond_prompts="",
                      batch_size: int = 4, **kwargs) -> np.ndarray:
        """Serving path: any number of prompts in chunks of ``batch_size``
        (``pipeline.generate_many``)."""
        return pipeline_mod.generate_many(list(prompts), uncond_prompts,
                                          batch_size=batch_size, **self._kw(kwargs))

    def prompt_matrix(self, prompt: str, uncond_prompt: str = "", *,
                      batch_size: int = 4, **kwargs) -> np.ndarray:
        """A1111's "Prompt matrix" script: ``"base|opt A|opt B"`` generates
        every subset combination of the |-separated options appended to the
        base prompt (2^n images, bit i of the index = option i included),
        through :meth:`generate_many`, and returns them as one grid image
        (uint8)."""
        parts = [p.strip() for p in prompt.split("|")]
        base, opts = parts[0], parts[1:]
        if not opts:
            raise ValueError("prompt_matrix needs |-separated options")
        if len(opts) > 4:
            raise ValueError("prompt_matrix caps at 4 options (16 images)")
        prompts = []
        for bits in range(2 ** len(opts)):
            chosen = [o for i, o in enumerate(opts) if bits >> i & 1]
            prompts.append(", ".join([base] + chosen))
        imgs = self.generate_many(prompts, uncond_prompt, batch_size=batch_size, **kwargs)
        cols = 2 ** ((len(opts) + 1) // 2)
        rows = len(prompts) // cols
        h, w = imgs.shape[1:3]
        return (imgs.reshape(rows, cols, h, w, 3)
                .transpose(0, 2, 1, 3, 4).reshape(rows * h, cols * w, 3))

    def xyz_grid(self, prompt: str, uncond_prompt: str = "", *,
                 x=None, y=None, **kwargs) -> np.ndarray:
        """A1111's "X/Y plot" script: sweep one generation keyword per axis
        (``x=("cfg_scale", [5, 7.5, 10])``, ``y=("sampler_name", ["euler",
        "dpm++"])``) and assemble the images into one grid (x along columns,
        y along rows)."""
        xk, xs = x if x is not None else (None, [None])
        yk, ys = y if y is not None else (None, [None])
        if xk is None and yk is None:
            raise ValueError("xyz_grid needs at least one of x=, y=")
        rows = []
        for yv in ys:
            row = []
            for xv in xs:
                kw = dict(kwargs)
                if xk is not None:
                    kw[xk] = xv
                if yk is not None:
                    kw[yk] = yv
                row.append(self.txt2img(prompt, uncond_prompt, **kw))
            rows.append(np.concatenate(row, axis=1))
        return np.concatenate(rows, axis=0)

    def edit(self, prompt: str, image, image_guidance_scale: float = 1.5,
             uncond_prompt: str = "", **kwargs) -> np.ndarray:
        """InstructPix2Pix editing: ``prompt`` is the edit instruction ("make
        it a watercolor"), ``image`` the picture to edit.  Needs an 8-channel
        checkpoint (``sd15_ip2p_config``).  Denoising runs from pure noise
        under dual guidance: ``cfg_scale`` pulls toward the instruction,
        ``image_guidance_scale`` toward the input image (Brooks et al. 2023;
        diffusers' instruct_pix2pix semantics)."""
        return pipeline_mod.generate(prompt, uncond_prompt, edit_image=image,
                                     image_guidance_scale=image_guidance_scale,
                                     **self._kw(kwargs))

    def hires_fix(self, prompt: str, uncond_prompt: str = "", *,
                  height: int = 1024, width: int = 1024,
                  base_height: Optional[int] = None, base_width: Optional[int] = None,
                  strength: float = 0.6, upscale_method: str = "bilinear",
                  **kwargs) -> np.ndarray:
        """Two-pass hi-res generation (the community "highres fix").

        Pass 1 runs txt2img at the base resolution (default: half the
        target); its latents are resized (``upscale_method``: "bilinear",
        "nearest", "cubic" or "lanczos3", as ``jax.image.resize`` computes
        them: ``utils/image.py``) and denoised again at the target size
        through latent-space img2img (``init_latents``: no decode/encode
        round trip).  ``strength`` is the second pass's denoise strength.
        ``"esrgan"`` upscales in pixel space with the attached upscaler
        (A1111's "upscaler" hires-fix modes): the base pass decoded,
        upscaled, lanczos3-resized to the exact target where the net's
        scale overshoots, then img2img at the target size."""
        from .utils.image import METHODS, resize

        if upscale_method != "esrgan" and upscale_method not in METHODS:
            raise ValueError(f"unknown upscale_method {upscale_method!r}")
        bh, bw = base_height or height // 2, base_width or width // 2
        kw = self._kw(dict(kwargs))
        if upscale_method == "esrgan":
            if self._upscaler is None:
                raise ValueError("upscale_method='esrgan' needs an "
                                 "attached upscaler (with_upscaler)")
            up_img = self.upscale(pipeline_mod.generate(prompt, uncond_prompt, height=bh,
                                                        width=bw, **kw))
            if up_img.shape[-3:-1] != (height, width):
                up_img = np.clip(np.round(resize(up_img.astype(np.float32),
                                                 up_img.shape[:-3] + (height, width, 3),
                                                 "lanczos3")), 0, 255).astype(np.uint8)
            return pipeline_mod.generate(prompt, uncond_prompt, height=height, width=width,
                                         input_image=up_img, strength=strength, **kw)
        _, lat = pipeline_mod.generate(prompt, uncond_prompt, height=bh, width=bw,
                                       return_latents=True, **kw)
        f = self.config.vae.downsample_factor
        up = resize(lat, lat.shape[:2] + (height // f, width // f), upscale_method)
        return pipeline_mod.generate(prompt, uncond_prompt, height=height, width=width,
                                     init_latents=up, strength=strength, **kw)

    @staticmethod
    def _fill_masked(init_image, mask_image, sigma: float = 8.0):
        """A1111 "masked content: fill": seed the repaint region with a
        heavy blur of the surrounding content (masked pixels first replaced
        by the unmasked mean so they don't bleed into the fill).  Host-side
        preprocessing; returns a uint8 image."""
        from .utils.annotators import blur

        img = _to_rgb_float(init_image)
        m = _mask_array(mask_image)
        if m.shape != img.shape[:2]:
            raise ValueError(f"mask shape {m.shape} != image {img.shape[:2]}")
        keep = (m <= 0.5)
        mean = img[keep].reshape(-1, 3).mean(axis=0) if keep.any() \
            else np.full(3, 127.5, np.float32)
        seeded = np.where(keep[..., None], img, mean)
        blurred = np.stack([blur(seeded[..., c] / 255.0, sigma=sigma)
                            for c in range(3)], axis=-1) * 255.0
        out = np.where(keep[..., None], img, blurred)
        return np.clip(np.round(out), 0, 255).astype(np.uint8)

    def inpaint(self, prompt: str, init_image, mask_image, strength: float = 1.0,
                uncond_prompt: str = "", *, full_res: bool = False,
                full_res_padding: int = 32, masked_content: str = "original",
                **kwargs) -> np.ndarray:
        """Repaint the masked region (mask 1 = repaint, 0 = keep).

        With a 9-channel inpaint checkpoint (``sd15_inpaint_config``,
        ``sd2_inpaint_config``, ``sdxl_inpaint_config``) the mask conditions
        the UNet; with any 4-channel checkpoint the pipeline blends latents
        (the kept region re-noised to every step's level, and exactly the
        original's at the end).  ``strength`` works as in img2img.

        ``full_res=True`` is A1111's "inpaint at full resolution": the
        mask's bounding box (+ ``full_res_padding`` pixels, grown toward the
        processing aspect ratio) is cropped, inpainted at ``height`` x
        ``width``, resized back and blended into the original image, which
        is returned at its own size; pixels outside the crop are the
        input's.  ``masked_content``: "original" (the image under the mask
        is the denoise start) or "fill" (seeded with a heavy blur of the
        surroundings)."""
        from .utils.image import resize

        if masked_content not in ("original", "fill"):
            raise ValueError(f"unknown masked_content {masked_content!r} "
                             "(original | fill)")
        if masked_content == "fill":
            init_image = self._fill_masked(init_image, mask_image)
        if not full_res:
            return pipeline_mod.generate(prompt, uncond_prompt, input_image=init_image,
                                         mask_image=mask_image, strength=strength,
                                         **self._kw(kwargs))
        h = kwargs.get("height", 512)
        w = kwargs.get("width", 512)
        img = _to_rgb_float(init_image)  # (H0, W0, 3), 0..255
        m = _mask_array(mask_image)
        H0, W0 = img.shape[:2]
        if m.shape != (H0, W0):
            raise ValueError(f"mask shape {m.shape} != image {(H0, W0)}")
        ys, xs = np.nonzero(m > 0.5)
        if len(ys) == 0:  # empty mask: nothing to crop around
            return pipeline_mod.generate(prompt, uncond_prompt, input_image=init_image,
                                         mask_image=mask_image, strength=strength,
                                         **self._kw(kwargs))
        y0 = max(int(ys.min()) - full_res_padding, 0)
        y1 = min(int(ys.max()) + 1 + full_res_padding, H0)
        x0 = max(int(xs.min()) - full_res_padding, 0)
        x1 = min(int(xs.max()) + 1 + full_res_padding, W0)
        # grow the short side toward the processing aspect ratio (h/w),
        # clamped to the image: keeps the upscale near-isotropic
        ch, cw = y1 - y0, x1 - x0
        if ch * w < cw * h:  # too wide: grow the height
            want = min(int(round(cw * h / w)), H0)
            extra = want - ch
            y0 = max(y0 - extra // 2, 0)
            y1 = min(y0 + want, H0)
            y0 = max(y1 - want, 0)
        elif cw * h < ch * w:  # too tall: grow the width
            want = min(int(round(ch * w / h)), W0)
            extra = want - cw
            x0 = max(x0 - extra // 2, 0)
            x1 = min(x0 + want, W0)
            x0 = max(x1 - want, 0)
        crop = img[y0:y1, x0:x1]
        mcrop = m[y0:y1, x0:x1]
        up_img = resize(crop, (h, w, 3), "bilinear")
        up_mask = resize(mcrop, (h, w), "bilinear")
        out = pipeline_mod.generate(prompt, uncond_prompt,
                                    input_image=np.clip(up_img, 0, 255).astype(np.uint8),
                                    mask_image=np.clip(up_mask, 0, 1), strength=strength,
                                    **self._kw(kwargs))
        back = resize(out.astype(np.float32), (y1 - y0, x1 - x0, 3), "bilinear")
        blend = mcrop[..., None]
        result = img.copy()
        result[y0:y1, x0:x1] = blend * back + (1.0 - blend) * crop
        return np.clip(np.round(result), 0, 255).astype(np.uint8)

    def outpaint(self, prompt: str, image, *, pixels: int = 64,
                 directions=("left", "right", "up", "down"), strength: float = 1.0,
                 mask_blur: int = 4, uncond_prompt: str = "", **kwargs) -> np.ndarray:
        """A1111's "poor man's outpainting": grow the canvas by ``pixels`` in
        the given directions, seed the new area with edge-replicated
        content, and inpaint it (the kept region is the original image).
        The processing resolution is the padded canvas, which must stay a
        multiple of the VAE factor.  Returns the padded canvas (uint8)."""
        img = _to_rgb_float(image)
        h0, w0 = img.shape[:2]
        top = pixels if "up" in directions else 0
        bot = pixels if "down" in directions else 0
        lef = pixels if "left" in directions else 0
        rig = pixels if "right" in directions else 0
        if not (top or bot or lef or rig):
            raise ValueError("no outpaint directions given")
        canvas = np.pad(img, ((top, bot), (lef, rig), (0, 0)), mode="edge")
        mask = np.ones(canvas.shape[:2], np.float32)
        mask[top:top + h0, lef:lef + w0] = 0.0  # keep the original
        h, w = canvas.shape[:2]
        f = self.config.vae.downsample_factor
        if h % f or w % f:
            raise ValueError(f"padded canvas {h}x{w} must be a multiple of "
                             f"{f}; adjust pixels/image size")
        kwargs.pop("height", None), kwargs.pop("width", None)
        return pipeline_mod.generate(
            prompt, uncond_prompt, input_image=np.clip(canvas, 0, 255).astype(np.uint8),
            mask_image=mask, mask_blur=mask_blur, strength=strength,
            height=h, width=w, **self._kw(kwargs))

    # -------------------------------------------------------- slice E
    def with_controlnet(self, controlnet, *, config: Optional[SDConfig] = None):
        """A bundle with a ControlNet attached (``models/controlnet.py``).

        ``controlnet`` is a checkpoint path (the CompVis ``control_model.*``
        layout, standalone or merged), a diffusers ControlNetModel
        directory, a ControlNet module, or a LIST of those
        (multi-ControlNet: the residuals sum; pass matching lists as
        ``control_image`` / ``controlnet_scale``).  ``config`` names the
        family the files are read for (by default the bundle's).
        Generation then takes ``control_image`` (+ ``controlnet_scale``)."""
        import os

        from .models import controlnet as controlnet_mod
        from .weights import convert, diffusers

        cfg = config or self.config

        def load(cn):
            if not isinstance(cn, str):
                return cn
            sd = diffusers.load_diffusers_controlnet(cn, cfg) if os.path.isdir(cn) \
                else convert.load_controlnet(cn, cfg)
            return controlnet_mod.build(cfg, device=self.device, state_dict=sd)

        controlnet = [load(c) for c in controlnet] \
            if isinstance(controlnet, (list, tuple)) else load(controlnet)
        return self._clone(models=dict(self.models, controlnet=controlnet))

    def with_ip_adapter(self, adapter, image_encoder, *, vision_config=None):
        """A bundle with an IP-Adapter attached (image prompting, Ye et al.
        2023; ``weights/ip_adapter.py``).

        ``adapter`` is an IP-Adapter weight file (.bin / .safetensors,
        h94-style) or an :class:`~.models.clip_vision.IPAdapter`;
        ``image_encoder`` the CLIP vision weight file (the HF
        ``CLIPVisionModelWithProjection`` layout) or a
        :class:`~.models.clip_vision.CLIPVision`; ``vision_config`` its
        ``CLIPVisionConfig`` (default ViT-H/14, the SD-1.x adapters'
        encoder; ``clip_vision.vit_bigg14()`` for the SDXL ones).
        Generation then takes ``ip_adapter_image`` (+ ``ip_adapter_scale``)."""
        from .models import clip_vision as cv
        from .weights import ip_adapter as ipw

        vis_cfg = vision_config or cv.vit_h14()
        dtype = self.config.policy.param_dtype
        if isinstance(adapter, str):
            adapter = cv.build_ip_adapter(ipw.load_ip_adapter(adapter, self.config.unet),
                                          dtype=dtype, device=self.device)
        if isinstance(image_encoder, str):
            image_encoder = cv.build_clip_vision(
                vis_cfg, dtype=dtype, device=self.device,
                state_dict=ipw.load_clip_vision(image_encoder, vis_cfg))
        return self._clone(models=dict(self.models, ip_adapter=adapter,
                                       clip_vision=image_encoder))

    def with_t2i_adapter(self, adapter):
        """A bundle with a T2I-Adapter attached (``models/t2i_adapter.py``:
        spatial conditioning whose features are computed once a request).

        ``adapter`` is a diffusers ``T2IAdapter`` directory or weight file,
        a T2IAdapter module, or a LIST of those (multi-adapter: the
        features sum; pass matching lists as ``adapter_image`` /
        ``adapter_scale``).  Generation then takes ``adapter_image`` (+
        ``adapter_scale``)."""
        from .models import t2i_adapter as t2i_mod
        from .weights import diffusers

        def load(ad):
            if not isinstance(ad, str):
                return ad
            return t2i_mod.build(self.config, device=self.device,
                                 state_dict=diffusers.load_t2i_adapter(ad, self.config))

        adapter = [load(a) for a in adapter] if isinstance(adapter, (list, tuple)) \
            else load(adapter)
        return self._clone(models=dict(self.models, t2i_adapter=adapter))

    # ------------------------------------- AnimateDiff and the upscalers
    def with_motion(self, motion):
        """A bundle with AnimateDiff motion modules attached
        (``models/motion.py``), enabling :meth:`animate`.

        ``motion`` is an ``mm_sd_v15[_v2]``-style weight file
        (``weights/animatediff.py``) or a ``(modules, max_len)`` pair:
        built modules (an ``nn.ModuleDict`` by site) or their port state
        dict, and the trained frame window (32 for v2)."""
        from .models import motion as motion_mod

        if isinstance(motion, str):
            from .weights.animatediff import load_motion_module

            motion = load_motion_module(motion, self.config.unet)
        mods, max_len = motion
        if not isinstance(mods, torch.nn.Module):
            mods = motion_mod.build(self.config.unet, state_dict=mods, device=self.device,
                                    dtype=self.config.policy.param_dtype)
        out = self._clone(models=dict(self.models, motion=mods.to(self.device)))
        out._motion_max = int(max_len)
        return out

    def animate(self, prompt: str, n_frames: int = 16, uncond_prompt: str = "",
                **kwargs) -> np.ndarray:
        """Text-to-video through the attached motion modules: ``(n_frames, H,
        W, 3)`` uint8 frames (``input_image`` for a coarse video2video).  A
        clip longer than the modules' trained window (``with_motion`` reads
        it from the file) sweeps overlapping frame windows of that length
        (the pipeline's ``motion_window``) unless ``motion_window`` is
        given."""
        if "motion" not in self.models:
            raise ValueError("no motion modules attached (with_motion)")
        mx = self._motion_max
        if mx and n_frames > mx and "motion_window" not in kwargs:
            kwargs["motion_window"] = mx
        return pipeline_mod.generate_images([prompt], uncond_prompt, n_frames=int(n_frames),
                                            **self._kw(kwargs))

    def with_upscaler(self, upscaler):
        """A bundle with an ESRGAN / RealESRGAN pixel upscaler attached
        (``models/esrgan.py``), enabling :meth:`upscale` and
        ``hires_fix(upscale_method="esrgan")``.

        ``upscaler`` is a weight file (``.pth`` / ``.safetensors``, old- or
        new-arch naming: ``weights/esrgan.py``) or a ``(params,
        ESRGANConfig)`` pair, ``params`` a port state dict or a built
        :class:`~.models.esrgan.RRDBNet`."""
        from .models import esrgan as esrgan_mod

        if isinstance(upscaler, str):
            from .weights.esrgan import load_esrgan

            upscaler = load_esrgan(upscaler)
        try:
            params, ecfg = upscaler
        except (TypeError, ValueError) as e:
            raise ValueError(
                "with_upscaler expects a weight file path or a "
                "(params, ESRGANConfig) pair, got "
                f"{type(upscaler).__name__}") from e
        # a 2-unpackable wrong value (a (path, strength) guess) fails here,
        # not deep inside upscale()
        if not isinstance(ecfg, esrgan_mod.ESRGANConfig) \
                or not isinstance(params, (dict, esrgan_mod.RRDBNet)):
            raise ValueError(
                "with_upscaler pair must be (params dict, ESRGANConfig); "
                f"got ({type(params).__name__}, {type(ecfg).__name__})")
        if isinstance(params, dict):
            params = esrgan_mod.build(ecfg, state_dict=params, device=self.device,
                                      dtype=self.config.policy.param_dtype)
        out = self._clone()
        out._upscaler = params.to(self.device)
        return out

    def upscale(self, image, *, tile: Optional[int] = None,
                tile_lanes: int = 8) -> np.ndarray:
        """Upscale an image (or a (B, H, W, 3) batch) with the attached
        ESRGAN (A1111's "Extras" upscale): uint8 of the same rank.
        ``tile``: RealESRGAN's padded tiles of this size, the tiles of one
        shape ``tile_lanes`` to a batch (``models/esrgan.upscale_image``)."""
        if self._upscaler is None:
            raise ValueError("no upscaler attached (with_upscaler)")
        from .models import esrgan as esrgan_mod

        return esrgan_mod.upscale_image(self._upscaler, image, self.config.policy,
                                        tile=tile, tile_lanes=tile_lanes)

    def sd_upscale(self, prompt: str, image, *, scale: float = 2.0,
                   strength: float = 0.3, overlap: int = 64, uncond_prompt: str = "",
                   height: int = 512, width: int = 512, batch_size: int = 4,
                   **kwargs) -> np.ndarray:
        """A1111's "SD upscale" script: lanczos3-upscale the image by
        ``scale``, img2img every overlapping ``height`` x ``width`` tile at
        ``strength`` (one processing shape, ``batch_size`` tiles a chunk
        through :meth:`generate_many`, each tile its own init image and
        noise), and stitch the tiles with two-sided linear feathering across
        the ``overlap`` bands, in float64.  Returns the upscaled uint8
        image."""
        from .utils.image import resize

        img = _to_rgb_float(image)
        h0, w0 = img.shape[:2]
        th, tw = int(round(h0 * scale)), int(round(w0 * scale))
        if th <= height and tw <= width:
            raise ValueError(f"upscaled size {th}x{tw} fits one processing "
                             f"tile {height}x{width}; use img2img directly")
        if th < height or tw < width:
            raise ValueError(
                f"upscaled size {th}x{tw} is smaller than the processing "
                f"tile {height}x{width} in one dimension; pick a tile size "
                "that fits both")
        if overlap >= min(height, width):
            raise ValueError("overlap must be smaller than the tile size")
        up = np.clip(resize(img, (th, tw, 3), "lanczos3"), 0, 255)

        def starts(total, tile):
            if total <= tile:
                return [0]
            s = list(range(0, total - tile, tile - overlap)) + [total - tile]
            return sorted(set(s))

        ys, xs = starts(th, height), starts(tw, width)
        tiles = np.stack([up[y:y + height, x:x + width]
                          for y in ys for x in xs]).astype(np.uint8)
        outs = self.generate_many([prompt] * len(tiles), [uncond_prompt] * len(tiles),
                                  batch_size=batch_size, input_image=tiles, height=height,
                                  width=width, strength=strength, **kwargs)

        # both edges of an interior tile ramp (leading 0 -> 1, trailing
        # 1 -> 0), strictly positive, so that neighbours crossfade fully
        def ramp(idx, last, tile):
            w = np.ones(tile, np.float32)
            e = min(overlap, tile)
            edge = np.linspace(0.0, 1.0, e + 2)[1:-1]
            if idx > 0:
                w[:e] = edge
            if idx < last:
                w[-e:] = np.minimum(w[-e:], edge[::-1])
            return w

        acc = np.zeros((th, tw, 3), np.float64)
        wacc = np.zeros((th, tw, 1), np.float64)
        tiles_out = iter(outs)
        for yi, y in enumerate(ys):
            for xi, x in enumerate(xs):
                wt = (ramp(yi, len(ys) - 1, height)[:, None]
                      * ramp(xi, len(xs) - 1, width)[None, :])[..., None]
                acc[y:y + height, x:x + width] += next(tiles_out).astype(np.float64) * wt
                wacc[y:y + height, x:x + width] += wt
        return np.clip(np.round(acc / np.maximum(wacc, 1e-8)), 0, 255).astype(np.uint8)
