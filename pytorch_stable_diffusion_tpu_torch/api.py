"""High-level API (port of ``api.py``): one object holding the models,
tokenizer and config, for repeated generation.

``StableDiffusion`` runs on the card unless ``device=`` names another
device (the CPU tests pass ``"cpu"``); without a card and without
``device=`` it raises.  The ``with_*`` methods (``with_lora``, ``with_vae``,
``merged_with``, ``with_hypernetwork``, ``with_textual_inversion``) return
new bundles and leave the original as it was; their models share every
parameter the transform leaves unchanged.  ``mesh=`` (slice H2) and the
methods of later slices raise ``NotImplementedError`` naming their slice
(ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import pipeline as pipeline_mod
from .models import assemble
from .models.config import SDConfig, sd15_config
from .weights.convert import load_sd_checkpoint
from .weights.tokenizer import CLIPTokenizer


def _unported(what: str, where: str):
    raise NotImplementedError(f"{what} is not ported yet: it comes with {where} "
                              f"(ROADMAP.md §1)")


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("StableDiffusion: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _as_models(cfg: SDConfig, device: torch.device, state_dicts):
    """Port state dicts (CPU tensors of any dtype) -> models on ``device``
    in the policy's dtype, with no second copy."""
    dtype = cfg.policy.param_dtype
    return assemble(cfg, {name: {k: v.to(device=device, dtype=dtype) for k, v in sd.items()}
                          for name, sd in state_dicts.items()})


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
    """

    def __init__(self, models, tokenizer, config: Optional[SDConfig] = None,
                 mesh=None, *, device=None):
        if mesh is not None:
            _unported("StableDiffusion(mesh=...)", "slice H2")
        self.device = _device(device)
        self.config = config or sd15_config()
        for m in models.values():
            m.to(self.device)
        self.models = models
        self.tokenizer = tokenizer
        self._hyper = None

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, vocab_path: str, merges_path: str,
                        config: Optional[SDConfig] = None, mesh=None,
                        loras: Optional[Sequence] = None, *, device=None):
        """A CompVis checkpoint file (``.safetensors`` or ``.ckpt``) and the
        CLIP tokenizer's files.  ``loras``: adapters merged into the weights
        once loaded — each entry a path, or a ``(path, scale)`` pair."""
        if mesh is not None:
            _unported("StableDiffusion.from_checkpoint(mesh=...)", "slice H2")
        config = config or sd15_config()
        dev = _device(device)
        models = _as_models(config, dev, load_sd_checkpoint(ckpt_path, config))
        if loras:
            from .weights import lora as lora_mod

            pairs = [(lora_mod.load_lora(x), 1.0) if isinstance(x, str)
                     else (lora_mod.load_lora(x[0]), float(x[1])) for x in loras]
            models = lora_mod.apply_loras(models, config, pairs)
        tokenizer = CLIPTokenizer.from_files(vocab_path, merges_path,
                                             max_len=config.clip.max_len)
        return cls(models, tokenizer, config, device=dev)

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
        kwargs.setdefault("models", self.models)
        kwargs.setdefault("tokenizer", self.tokenizer)
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

    # ------------------------------------------------ later slices' methods
    def edit(self, *args, **kwargs):
        _unported("StableDiffusion.edit (InstructPix2Pix)", "slice C3")

    def hires_fix(self, *args, **kwargs):
        _unported("StableDiffusion.hires_fix", "slice C3")

    def inpaint(self, *args, **kwargs):
        _unported("StableDiffusion.inpaint", "slice C3")

    def with_controlnet(self, *args, **kwargs):
        _unported("StableDiffusion.with_controlnet", "slice E")

    def with_ip_adapter(self, *args, **kwargs):
        _unported("StableDiffusion.with_ip_adapter", "slice E")

    def with_t2i_adapter(self, *args, **kwargs):
        _unported("StableDiffusion.with_t2i_adapter", "slice E")

    def with_motion(self, *args, **kwargs):
        _unported("StableDiffusion.with_motion (AnimateDiff)", "slice G")

    def animate(self, *args, **kwargs):
        _unported("StableDiffusion.animate (AnimateDiff)", "slice G")

    def with_upscaler(self, *args, **kwargs):
        _unported("StableDiffusion.with_upscaler (ESRGAN)", "slice G")

    def upscale(self, *args, **kwargs):
        _unported("StableDiffusion.upscale (ESRGAN)", "slice G")

    def outpaint(self, *args, **kwargs):
        _unported("StableDiffusion.outpaint", "slice G")

    def sd_upscale(self, *args, **kwargs):
        _unported("StableDiffusion.sd_upscale", "slice G")
