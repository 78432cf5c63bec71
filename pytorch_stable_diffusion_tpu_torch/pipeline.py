"""txt2img / img2img / inpainting / InstructPix2Pix generation (port of
``pipeline.py``: CFG, the 18 samplers and slice C3's families).

Same public keyword surface as the JAX package's ``generate()`` and
``generate_images()``, in eager PyTorch:

* ``device`` is where the work runs: the models are moved there, as the
  reference's ``generate`` does; by default it is the models' device.
  ``idle_device`` is accepted and ignored, as in the JAX package.
* All noise of a request is drawn up front on CPU generators (named
  streams 'latent_init' / 'encoder_noise' / 'sampler', and 'restart' /
  'dpm_fast' / 'dpm_adaptive' for the samplers of those names, per sample
  and per step, op, segment or iteration: ``core/rng.py``) and copied to
  the device once, so a seed gives the same noise on any device and the
  loop never waits on the host.  Inpainting adds 'mask_encoder_noise'
  (per sample: the 9-channel UNet's masked-image encode) and 'inpaint'
  (per sample and step: the latent blend's re-noising).  Parity tests
  inject recorded noise with ``fixed_noise`` (NCHW arrays: latent_init
  (B, 4, h, w), sampler_noise (steps, B, 4, h, w), encoder_noise and
  mask_encoder_noise (B, 4, h, w); without mask_encoder_noise that encode
  takes zeros, and the blend re-uses sampler_noise, as in the JAX
  package); restart, dpm_fast and
  dpm_adaptive refuse it, and prompt editing, with ``ValueError``, as in
  the JAX package.
* Samplers (``sampler_name``, :data:`SAMPLERS`) and grids
  (``timestep_spacing``, ``ddpm.timesteps_for``; lcm, dpm_fast and
  dpm_adaptive take only "uniform" and raise ``ValueError`` otherwise),
  ``ddim_eta`` and the config's ``zero_terminal_snr``, as in the JAX
  package: see :func:`_sample` for the loops.  Every timestep a loop
  evaluates is a Python int on the host that indexes a table of the
  training timesteps put on the device once, so no step copies to the
  device; every per-step scalar is computed on the host.  The loops make
  no host sync, but for dpm_adaptive's one a 3-evaluation iteration
  (``sampling/dpm_adaptive.py``).
* CFG runs cond and uncond as one batched UNet call per evaluation,
  combined as ``uncond + scale * (cond - uncond)`` in float32.
* img2img encodes the init image (one for the whole batch, or a
  (B, H, W, 3) array of one per prompt), noises it to the timestep of
  ``start_step_for_strength`` (restart and dpm_fast: of their own grids'
  entry maps) and denoises from there.  ``init_latents`` is img2img in
  latent space: ready latents in the port's layout, (B|1, 4, h, w) as
  ``generate(return_latents=True)`` returns them (SDXL base -> refiner),
  skip the VAE encoder.
* Families (``models/config.py``): SD-1.x and SD-2.x condition the UNet
  on one tower's hidden state (SD-2.x: the OpenCLIP ViT-H penultimate
  layer, final-normed; "v" prediction is turned into epsilon at every
  evaluation); SDXL on the CLIP-L and bigG penultimate hidden states
  concatenated (2048 features), with the added conditioning of the bigG
  pooled vector and six size ids (``original_size``, ``crop_coords``,
  ``target_size``: :func:`canonical_size_ids`), each sinusoidally embedded;
  the refiner on one bigG tower, its hidden state the context and its
  pooled vector the added conditioning, with five ids (the last
  ``cfg.aesthetic_score``).  Each CFG lane's added conditioning comes from
  its own prompt; long prompts pool window 0 only.
* ``encode_tile`` / ``decode_tile`` (latent px) run the VAE's
  image-resolution convs over overlapping tiles (``models/vae.py``), for
  high-resolution requests; the mid block's attention still runs whole.
* Exact-mode requests are served up to :data:`MAX_VALIDATED_ATTN_TOKENS`
  level-1 tokens (2048² at SD-1.5); larger ones raise ``ValueError``, as
  in the JAX package, unless Hypertile tiles level 1.
* Output: decoded (-1, 1) rescaled to (0, 255), clamped, truncated to
  uint8 (H, W, 3) — the reference's contract.
* Prompt features (slice D1), as in the JAX package: ``long_prompts``
  (windows of ``max_len`` tokens encoded in one batched CLIP call, their
  hiddens concatenated into one long context; a ``BREAK`` keyword turns it
  on), ``emphasis`` (``(word:1.3)``, per-token weights applied to the
  hidden states with the row mean restored), prompt editing and
  alternation (``[a:b:N]``, ``[a|b]``: the K distinct conditionings
  encoded together, each step indexing its own from a host-side map) and
  ``clip_skip``.  A context of 256+ tokens (4+ windows at SD-1.5) sends
  every cross-attention to the one-pass flash kernel K2 on the kernel
  backend.
* ``hypernetwork`` (slice D): the loader's (activation, activate_output)
  pair, the nets in ``models["hypernetwork"]`` (``weights/hypernetwork.py``);
  they transform the CFG batch's context once a request into a (ctx_k,
  ctx_v) pair that every cross-attention projects k and v from.  Refused
  with prompt editing, as in the JAX package.
* :func:`generate_many` serves any number of prompts in chunks of one
  batch size, the images left on the device until the last chunk.
* Slice C3, as in the JAX package.  ``mask_image`` (1 = repaint) with an
  init image inpaints: a 9-channel UNet (``sd15_inpaint_config``,
  ``sd2_inpaint_config``, ``sdxl_inpaint_config``) takes [latents, the
  nearest-downsampled mask, the latents of the masked image] at every
  evaluation; any other blends latents, re-noising the init's to each
  step's level in the kept region and pasting them exactly at the end
  (``mask_blur`` softens the mask first).  ``edit_image`` runs
  InstructPix2Pix (``sd15_ip2p_config``): three lanes [text + image, image,
  neither], the edit image's latents the encoder's mode divided by the
  scale factor, combined as ``e_u + cfg_scale (e_t - e_i) +
  image_guidance_scale (e_i - e_u)``.  An LCM-distilled UNet
  (``time_cond_dim``) takes the guidance embedding of ``cfg_scale - 1``,
  usually with ``do_cfg=False``.  ``color_correction`` histogram-matches
  each output to its init image on the host.  The own-grid samplers
  refuse inpainting, with ``ValueError``.
* Slice E, the side nets, as in the JAX package, every one composing with
  every loop family of :func:`_sample`.  ``control_image`` (one a
  ControlNet of ``models["controlnet"]``, a module or a list) with
  ``controlnet_scale``: each net's hint features once a request, its
  residuals at every evaluation from the 4-channel latents, summed over
  the nets.  ``adapter_image`` / ``adapter_scale`` (``models["t2i_adapter"]``):
  the features once a request, scaled and summed over the adapters.
  ``ip_adapter_image`` / ``ip_adapter_scale`` (``models["ip_adapter"]`` and
  the tower ``models["clip_vision"]`` of ``clip_vision_config``): the image
  tokens once a request, the negative lane's from a zero embedding (a zero
  image for the "plus" adapters).  ``reference_image`` with
  ``reference_fidelity`` and ``reference_mode`` ("attn", "adain",
  "adain+attn"): the reference encoded once (stream 'ref_encoder', per
  sample), re-noised at every evaluation (stream 'ref_noise', per sample
  and step) and run through a capture pass of the UNet (2 lanes under CFG,
  no side nets) whose banked tokens or statistics the main pass reads;
  ``plain_mask`` [0]*B + [1]*B lerps the uncond lanes back by the
  fidelity.  Scales and the fidelity are tensors.  Reference-only refuses
  ``fixed_noise`` and 9-channel inpainting; InstructPix2Pix refuses
  ControlNet, T2I-Adapter, IP-Adapter and reference-only, with the JAX
  package's ``ValueError``s.

* Slice F, the guidance and approximate modes, as in the JAX package.
  Guidance: ``guidance_rescale`` (the combined prediction's per-sample std
  pulled back toward the conditional one's), ``dynamic_threshold`` (a
  per-sample |x0| quantile clip), ``pag_scale`` (one more evaluation of the
  conditional lanes with the mid block's self-attention the identity map),
  ``sag_scale`` (the mid block's attention map marks the salient tokens;
  the base lanes' x0 blurred there, re-noised and evaluated once more),
  composable ``AND`` prompts (n_and cond lanes, part-major, and the uncond
  lanes; a (B, n_and) weight tensor) with ``region_masks`` (each part's
  area-mean latent mask).  Noise: ``variation_seed`` / ``variation_strength``
  (the variation seed's 'latent_init' draw slerped in, :func:`slerp_noise`)
  and ``noise_multiplier``, both on the host before the copy to the
  device.  Approximate modes: ``deepcache`` (every N-th evaluation the full
  UNet, the rest its shallow slice against the cached deep feature; heun's
  corrector and the dpm2 family's midpoint always shallow), ``tome_ratio``
  and the config's Hypertile (``models/config.with_hypertile``,
  :func:`models.config.fast_preset`), which lifts the 65536-token guard
  where it tiles level 1, and ``freeu``.  ``tiling`` runs the request under
  ``ops/conv.circular_padding``.  Each refuses the compositions and
  ``fixed_noise`` cases the JAX package refuses, with its ``ValueError``.
* Slice G, as in the JAX package.  ``n_frames`` (AnimateDiff, the motion
  modules of ``models["motion"]``): one prompt becomes ``n_frames`` lanes in
  each CFG group (the cond lanes, then the uncond ones, the frame index
  fastest), and every UNet evaluation takes the modules;
  ``motion_window`` / ``motion_stride`` sweep overlapping frame windows,
  one UNet call each, and average each frame's eps over its windows.
  ``panorama`` / ``panorama_window`` / ``panorama_stride``
  (MultiDiffusion): the UNet sweeps overlapping windows of the canvas, one
  call each, and each latent pixel's eps is the average over its windows;
  the sampler then steps the whole canvas.  Both sum and count in fp32.
  Under ``panorama`` the 65536-token guard counts a window's tokens, not
  the canvas's (the JAX package refuses the wide canvases there).  Both
  refuse ``fixed_noise`` and the compositions the JAX package refuses, with
  its ``ValueError``s.

* Slice H2.  ``progress`` prints the JAX package's ``denoise step i/n``
  line (rewritten in place) from the host loop at each UNet evaluation:
  the steps enqueued, with no device sync.  The config's ``quant`` tier (``ops/quant.py``) reaches
  the UNet's evaluations (and reference-only's capture pass), not CLIP,
  the VAE or the side nets; each weight is quantized once a request.
  ``mesh`` (``core/mesh.py``, one process a rank): the batch is split over
  the data axis, each rank drawing its samples' noise at their indices in
  the whole batch and the images gathered so that every rank returns all
  of them; the batch-wide reductions (the int8 activation scale,
  dpm_adaptive's error norm) are taken over the whole batch.  A model axis
  > 1 turns ``fuse_qkv`` off, as in the JAX package: the models are
  sharded by ``parallel/tp.shard_models`` (``generate_images_tp``,
  ``StableDiffusion(mesh=)``).  What a data rank would decide from its
  prompts alone (long prompts on, the window count) is decided from the
  whole batch.

* Slice H3a.  ``sequence_parallel=True`` over a mesh with a model axis
  of 2 or more (``parallel/sp.generate_spatial``): the models stay whole
  and ``fuse_qkv`` on; every UNet (and ControlNet) evaluation takes the
  rank's rows of its input and gathers its output's rows
  (``core/mesh.split_rows``), while the host loop, the samplers, the
  guidance combines, the VAE and the text towers run on the whole latents
  on every model rank.  The res blocks and the ControlNet take the
  "plain" conv tier, as the JAX package takes its ``"xla"`` one.  Under a
  data axis too, each data rank's model group splits the rows of its
  samples.  The JAX package's refusals, with its messages: a model axis
  below 2, a latent height the axis does not divide, ToMe, Hypertile,
  ``n_frames`` and ``panorama``.

* Slice H3b.  What a request runs on the device is three functions of
  tensors: :func:`prepare` (the once-a-request work: text, encodes, side-net
  features), :func:`guided_eps` (one guided UNet evaluation, with its
  static modes in a :class:`Guidance`) and :func:`decode`.  ``generate``
  calls them eagerly, around the host loop :func:`_denoise`, and
  ``utils/aot.py`` exports them with ``torch.export`` and runs the same
  loop around the exported programs, so that an artifact gives eager's
  bits.  The modes outside the exported key (DeepCache, the frame and
  panorama windows, reference-only's capture pass, sequence parallelism,
  dynamic thresholding, prompt editing) ride in eager hooks around them.

Every keyword of the JAX ``generate()`` is ported; a value the JAX
package does not know raises ``ValueError``, as it does there.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np
import torch

from . import prompt_schedule
from .core import mesh as mesh_mod
from .core import rng as rng_mod
from .models import target_device
from .models import unet as unet_mod
from .models import vae as vae_mod
from .models.config import (SDConfig, check_ported, sd15_config, with_clip_skip, with_freeu,
                            with_tome)
from .ops import conv as conv_ops
from .ops import quant as quant_mod
from .sampling import (ddim, ddpm, dpm, dpm2, dpm_adaptive, dpm_fast, euler, lcm, lms,
                       pndm, restart, unipc)

#: the JAX package's samplers, all ported
SAMPLERS = ("ddpm", "ddim", "dpm++", "dpm++_sde", "dpm++_3m_sde", "dpm++_2s_a",
            "euler", "euler_a", "heun", "unipc", "lcm", "plms", "lms",
            "dpm2", "dpm2_a", "restart", "dpm_fast", "dpm_adaptive")
#: samplers that run their own op/segment/iteration grid and noise stream
_OWN_GRID = ("restart", "dpm_fast", "dpm_adaptive")

#: Largest global self-attention sequence (level-1 tokens) served: the JAX
#: package's limit and ``ValueError`` contract (its ``pipeline.py``), which
#: the port keeps; 2048² at SD-1.5 is 65536 tokens.  Hypertile lifts it
#: where its plan tiles level 1 (the JAX package lifts it whenever hypertile
#: is on, even where ``min_tokens`` or a prime side leaves level 1 whole).
MAX_VALIDATED_ATTN_TOKENS = 65536

def _progress_tick(step_i: int, n_steps: int) -> None:
    """The JAX package's denoise progress line (the reference's tqdm bar)."""
    print(f"\rdenoise step {step_i + 1}/{n_steps}", end="", flush=True)
    if step_i + 1 == n_steps:
        print()


# --------------------------------------------------------------- tokenizing
def _encode_tokens(tokenizer, prompts, max_len: int) -> np.ndarray:
    """Our CLIPTokenizer or a transformers tokenizer (duck-typed)."""
    if hasattr(tokenizer, "batch_encode"):
        ids = tokenizer.batch_encode(prompts)
    else:
        ids = tokenizer.batch_encode_plus(
            prompts, padding="max_length", max_length=max_len, truncation=True
        ).input_ids
    return np.asarray(ids, np.int64)


def _tokenize(tokenizer, prompts, uncond, max_len: int, *, long_prompts: bool,
              emphasis: bool, agree=None):
    """-> (cond_tokens, uncond_tokens, cond_weights, uncond_weights).

    Tokens are (N, L) int64, or (N, k, L) with long prompts of k > 1
    windows (every prompt padded to the common k with ``[sot] + [eot] *
    (L - 1)`` windows of weight 1); weights are float32 of the same shape,
    or None without emphasis.  A ``BREAK`` keyword turns long prompts on.
    ``agree``: a data rank's values -> their MAX over the whole batch
    (``core/mesh.agree_max``), so that the switch and k are the batch's."""
    agree = agree or list
    if not long_prompts and hasattr(tokenizer, "encode_windows") and agree([any(
            re.search(r"\bBREAK\b", t) for t in prompts + uncond)])[0]:
        # without windows the keyword would encode as a literal "break" token
        long_prompts = True
    if emphasis and not hasattr(tokenizer, "encode_weighted"):
        raise ValueError("emphasis requires the built-in CLIPTokenizer "
                         "(encode_weighted)")
    if long_prompts:
        if not hasattr(tokenizer, "encode_windows"):
            raise ValueError("long_prompts requires the built-in "
                             "CLIPTokenizer (encode_windows)")
        if emphasis:
            cw, cww = map(list, zip(*[tokenizer.encode_windows_weighted(t)
                                      for t in prompts]))
            uw, uww = map(list, zip(*[tokenizer.encode_windows_weighted(t)
                                      for t in uncond]))
        else:
            cw = [tokenizer.encode_windows(t) for t in prompts]
            uw = [tokenizer.encode_windows(t) for t in uncond]
        k = agree([max(len(w) for w in cw + uw)])[0]
        pad_win = [tokenizer.sot] + [tokenizer.eot] * (max_len - 1)

        def stack(wins, pad=pad_win, dt=np.int64):
            return np.asarray([w + [pad] * (k - len(w)) for w in wins], dt)

        tokens = [stack(cw), stack(uw)]
        weights = [stack(cww, [1.0] * max_len, np.float32),
                   stack(uww, [1.0] * max_len, np.float32)] if emphasis else [None, None]
        if k == 1:
            tokens = [t[:, 0] for t in tokens]
            weights = [None if w is None else w[:, 0] for w in weights]
        return (*tokens, *weights)
    if emphasis:
        cw = [tokenizer.encode_weighted(t) for t in prompts]
        uw = [tokenizer.encode_weighted(t) for t in uncond]
        return (np.asarray([p[0] for p in cw], np.int64),
                np.asarray([p[0] for p in uw], np.int64),
                np.asarray([p[1] for p in cw], np.float32),
                np.asarray([p[1] for p in uw], np.float32))
    return (_encode_tokens(tokenizer, prompts, max_len),
            _encode_tokens(tokenizer, uncond, max_len), None, None)


def _emphasize(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A1111 emphasis: scale each token's hidden state (B, L, d) by its
    weight (B, L), then restore each row's mean, in fp32.

    The weighted mean is taken in delta form, ``mean(h) + mean(h * (w -
    1))``, so that w == 1 adds an exact zero; rows whose means sit within
    fp32 cancellation noise of zero skip the restore (ratio 1).  With every
    weight 1 the result is bit-identical to ``h``."""
    hf = h.float()
    wf = w.float()[:, :, None]
    m0 = hf.mean(dim=(1, 2), keepdim=True)
    delta = (hf * (wf - 1.0)).mean(dim=(1, 2), keepdim=True)
    scale = hf.abs().mean(dim=(1, 2), keepdim=True)
    den = m0 + delta
    ok = (den.abs() > 1e-6 * scale) & (m0.abs() > 1e-6 * scale)
    one = torch.ones_like(den)
    ratio = torch.where(ok, m0 / torch.where(ok, den, one), one)
    return (hf * wf * ratio).to(h.dtype)


def canonical_size_ids(cfg: SDConfig, height: int, width: int,
                       original_size, crop_coords, target_size):
    """SDXL micro-conditioning (diffusers ``original_size`` /
    ``crops_coords_top_left`` / ``target_size``) as the 6-tuple (orig_h,
    orig_w, crop_top, crop_left, tgt_h, tgt_w) of floats, or None where it
    equals the implicit ids (h, w, 0, 0, h, w); ``ValueError`` for a
    family without added conditioning, and for ``target_size`` on the
    refiner (5 ids), as in the JAX package."""
    if original_size is None and tuple(crop_coords) == (0, 0) and target_size is None:
        return None
    if cfg.unet.add_embed_dim is None:
        raise ValueError("original_size/crop_coords/target_size are SDXL "
                         "micro-conditioning (add_embed families only)")
    if cfg.unet.add_time_ids == 5 and target_size is not None:
        raise ValueError("refiner families (5 add_time_ids) have no target_size id; "
                         "drop target_size")
    oh, ow = original_size or (height, width)
    tgt_h, tgt_w = target_size or (height, width)
    size_ids = (float(oh), float(ow), float(crop_coords[0]), float(crop_coords[1]),
                float(tgt_h), float(tgt_w))
    if size_ids == (float(height), float(width), 0.0, 0.0, float(height), float(width)):
        return None
    return size_ids


def _size_embedding(cfg: SDConfig, height: int, width: int, size_ids) -> torch.Tensor:
    """(1, n_ids * size_dim) float32 on the host: each add_time_id
    sinusoidally embedded at (add_embed_dim - pooled width) / n_ids
    features (SDXL 256).  The base's 6 ids (orig_h, orig_w, crop_top,
    crop_left, tgt_h, tgt_w) or the refiner's 5 (the last the aesthetic
    score)."""
    n_ids = cfg.unet.add_time_ids
    pooled_dim = (cfg.clip if cfg.clip2 is None else cfg.clip2).d_model
    base4 = size_ids[:4] if size_ids else (height, width, 0, 0)
    if n_ids == 5:
        ids = list(base4) + [cfg.aesthetic_score]
    else:
        ids = list(base4) + list(size_ids[4:6] if size_ids else (height, width))
    size_dim = (cfg.unet.add_embed_dim - pooled_dim) // n_ids
    return unet_mod.timestep_embedding(torch.tensor(ids, dtype=torch.float32),
                                       size_dim).reshape(1, -1)


def _encode_text(clip, tokens: torch.Tensor, weights: Optional[torch.Tensor],
                 cfg: SDConfig, *, tower=None, pooled: bool = False):
    """(N, L) or (N, k, L) tokens -> (N, [k *] L, d) context: the k windows
    of every prompt go through one batched call of the tower (``tower``,
    by default ``cfg.clip``), each weighted on its own, and their hiddens
    are concatenated.  With ``pooled`` -> (context, (N, d) pooled vector of
    window 0)."""
    win_k = None
    if tokens.dim() == 3:
        n, win_k, length = tokens.shape
        tokens = tokens.reshape(n * win_k, length)
        if weights is not None:
            weights = weights.reshape(tokens.shape)
    kw = dict(fuse_qkv=cfg.fuse_qkv, cfg=tower or cfg.clip)
    h, pool = clip.forward_with_pooled(tokens, cfg.policy, **kw) if pooled \
        else (clip(tokens, cfg.policy, **kw), None)
    if weights is not None:
        h = _emphasize(h, weights)
    if win_k is not None:
        h = h.reshape(n, win_k * h.shape[1], h.shape[2])
        pool = None if pool is None else pool.reshape(n, win_k, -1)[:, 0]
    return (h, pool) if pooled else h


def _encode_prompts(models, tokens: torch.Tensor, weights: Optional[torch.Tensor],
                    cfg: SDConfig, size_emb: Optional[torch.Tensor] = None):
    """Tokens -> (context, add_cond) of the family (:func:`_encode_text` for
    each tower).  ``add_cond`` is None for the single-tower families; for
    SDXL (the CLIP-L and bigG hiddens side by side, bigG's pool) and the
    refiner (one tower, context and pool) the (N, add_embed_dim) float32
    concatenation of the pooled vector and ``size_emb`` (on the device)."""
    if cfg.unet.add_embed_dim is None:
        return _encode_text(models["clip"], tokens, weights, cfg), None
    if cfg.clip2 is None:
        context, pooled = _encode_text(models["clip"], tokens, weights, cfg, pooled=True)
    else:
        hidden2, pooled = _encode_text(models["clip2"], tokens, weights, cfg,
                                       tower=cfg.clip2, pooled=True)
        context = torch.cat([_encode_text(models["clip"], tokens, weights, cfg), hidden2],
                            dim=-1)
    add_cond = torch.cat([pooled.float(), size_emb.expand(pooled.shape[0], -1)], dim=-1)
    return context, add_cond


# ------------------------------------------------------------ image helpers
def rescale(x, old_range, new_range, clamp: bool = False):
    """Linear range remap (numpy arrays or tensors)."""
    old_min, old_max = old_range
    new_min, new_max = new_range
    x = (x - old_min) * (new_max - new_min) / (old_max - old_min) + new_min
    if clamp:
        x = x.clamp(new_min, new_max) if isinstance(x, torch.Tensor) \
            else np.clip(x, new_min, new_max)
    return x


def get_time_embedding(timestep, device=None) -> torch.Tensor:
    """(1, 320) float32 sinusoidal embedding of one timestep, the JAX
    package's reference helper, on the card unless ``device`` names
    another device (with no card and no device named it raises)."""
    return unet_mod.timestep_embedding(timestep, 320,
                                       device=target_device(device, "get_time_embedding"))


def _prepare_image(input_image, width: int, height: int) -> np.ndarray:
    """PIL image / (H, W[, C]) array -> (1, 3, H, W) float32 in [-1, 1].

    A 4-D (B, H, W, C) array is a per-sample batch (each sample its own
    init image, as in the JAX package) and returns (B, 3, H, W)."""
    if not isinstance(input_image, np.ndarray) and hasattr(input_image, "resize"):
        arr = np.asarray(input_image.resize((width, height)), np.float32)
    else:
        arr = np.asarray(input_image, np.float32)
        spatial = arr.shape[1:3] if arr.ndim == 4 else arr.shape[:2]
        if spatial != (height, width):
            raise ValueError(f"input image must be {height}x{width}, got {arr.shape}")
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = rescale(arr[..., :3], (0.0, 255.0), (-1.0, 1.0))
    arr = arr if arr.ndim == 4 else arr[None]
    return np.ascontiguousarray(arr.transpose(0, 3, 1, 2))


def _prepare_mask(mask_image, width: int, height: int) -> np.ndarray:
    """PIL image / array -> (1, H, W, 1) float32 in [0, 1].

    Convention (diffusers-compatible): 1 = repaint, 0 = keep original.
    """
    if not isinstance(mask_image, np.ndarray) and hasattr(mask_image, "resize"):
        m = mask_image.convert("L") if hasattr(mask_image, "convert") else mask_image
        arr = np.asarray(m.resize((width, height)), np.float32) / 255.0
    else:
        arr = np.asarray(mask_image, np.float32)
        if arr.ndim == 3:
            arr = arr[..., 0]
        if arr.shape != (height, width):
            raise ValueError(f"mask must be {height}x{width}, got {arr.shape}")
        if arr.max() > 1.0:
            arr = arr / 255.0
    return np.clip(arr, 0.0, 1.0)[None, ..., None]


def mask_to_latent_nearest(mask, factor: int):
    """(B, H, W, 1) -> (B, H/f, W/f, 1) by nearest sampling (the 9-channel
    inpaint UNet's training-time mask conditioning; diffusers uses
    ``interpolate(mode="nearest")`` which picks the top-left of each cell)."""
    return mask[:, ::factor, ::factor, :]


def mask_to_latent_area(mask, factor: int):
    """(B, H, W, 1) -> (B, H/f, W/f, 1) by area mean — soft edges for the
    latent-blend inpaint mode (keeps the seam smooth after decode)."""
    b, h, w, _ = mask.shape
    return mask.reshape(b, h // factor, factor, w // factor, factor, 1).mean(
        axis=(2, 4))


def match_histograms(src: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-channel exact histogram matching (skimage ``match_histograms``
    semantics) — A1111's img2img "apply color correction" uses this to pin
    the output's palette to the init image's.  uint8 HWC in/out."""
    out = np.empty_like(src)
    for c in range(src.shape[-1]):
        s = src[..., c].ravel().astype(np.float64)
        r = ref[..., c].ravel().astype(np.float64)
        s_vals, s_inv, s_counts = np.unique(s, return_inverse=True,
                                            return_counts=True)
        r_vals, r_counts = np.unique(r, return_counts=True)
        s_q = np.cumsum(s_counts) / s.size
        r_q = np.cumsum(r_counts) / r.size
        mapped = np.interp(s_q, r_q, r_vals)
        out[..., c] = mapped[s_inv].reshape(src.shape[:-1])
    return out.astype(src.dtype)


def _lane(ctx, sl):
    """The lanes ``sl`` of a context that may be a hypernetwork's (ctx_k,
    ctx_v) pair."""
    return tuple(t[sl] for t in ctx) if isinstance(ctx, tuple) else ctx[sl]


def gaussian_blur(x: torch.Tensor, ksize: int = 9, sigma: float = 1.0) -> torch.Tensor:
    """Separable depthwise gaussian blur of (B, C, H, W) with reflect
    padding: diffusers' ``gaussian_blur_2d``, SAG's degradation (port of the
    JAX package's ``gaussian_blur``; the taps in float64 on the host, then
    x's dtype)."""
    ax = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k1 = np.exp(-0.5 * (ax / sigma) ** 2)
    k1 = torch.from_numpy(k1 / k1.sum()).to(x.dtype)
    c, pad = x.shape[1], ksize // 2
    kv = k1.reshape(1, 1, ksize, 1).expand(c, 1, ksize, 1).to(x.device)
    kh = k1.reshape(1, 1, 1, ksize).expand(c, 1, 1, ksize).to(x.device)
    y = torch.nn.functional.pad(x, (pad, pad, pad, pad), mode="reflect")
    y = torch.nn.functional.conv2d(y, kv, groups=c)
    return torch.nn.functional.conv2d(y, kh, groups=c)


def slerp_noise(t, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Per-sample spherical interpolation between two noise tensors (the
    A1111 variation-seed combiner; port of the JAX package's).  It keeps the
    result's norm on the gaussian shell, which a lerp would shrink.  Exact
    at the ends: t = 0 returns ``low`` and t = 1 ``high`` bit for bit
    (sin(w)/sin(w) == 1 and sin(0) == 0 in IEEE); near-parallel inputs
    (sin(omega) ~ 0) take the lerp."""
    b = low.shape[0]
    lo, hi = low.reshape(b, -1).float(), high.reshape(b, -1).float()
    lon = lo / torch.linalg.vector_norm(lo, dim=1, keepdim=True)
    hin = hi / torch.linalg.vector_norm(hi, dim=1, keepdim=True)
    dot = torch.clamp((lon * hin).sum(dim=1, keepdim=True), -1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    safe = so.abs() > 1e-6
    so_ = torch.where(safe, so, torch.ones_like(so))
    t = torch.as_tensor(t, dtype=torch.float32, device=lo.device)
    out = torch.where(safe, (torch.sin((1.0 - t) * omega) / so_) * lo
                      + (torch.sin(t * omega) / so_) * hi, (1.0 - t) * lo + t * hi)
    return out.reshape(low.shape)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """(B, H, W, C) host array -> (B, C, H, W) float32 tensor."""
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2), np.float32))


def _inpaint_mode(cfg: SDConfig, mask_image, input_image, init_latents) -> Optional[str]:
    """"unet9" for a 9-channel inpaint checkpoint (the mask conditions the
    UNet), "blend" for a mask on any other (latent-blend masking), else
    None; the JAX package's ValueErrors."""
    inpaint = None
    if cfg.unet.in_channels == 9:
        inpaint = "unet9"
        if mask_image is None and input_image is not None:
            raise ValueError("inpaint checkpoint: mask_image is required "
                             "with input_image")
    elif mask_image is not None:
        if init_latents is not None:
            raise ValueError("inpainting needs pixel input_image, not init_latents")
        if input_image is None:
            raise ValueError("mask_image requires input_image (the region "
                             "outside the mask is kept from it)")
        inpaint = "blend"
    if init_latents is not None:
        if input_image is not None:
            raise ValueError("pass input_image OR init_latents, not both")
        if inpaint is not None:
            raise ValueError("inpainting needs pixel input_image, not init_latents")
    return inpaint


def _check_ip2p(cfg: SDConfig, *, img2img: bool, do_cfg: bool, mask_image,
                edited: bool, control_image=None, adapter_image=None,
                guidance_rescale: float = 0.0) -> None:
    """InstructPix2Pix's ValueErrors, as in the JAX package (``edited``:
    PAG, SAG, AND or prompt edits/alternations)."""
    if cfg.unet.in_channels != 2 * cfg.vae.latent_channels:
        raise ValueError(
            "edit_image needs an InstructPix2Pix checkpoint "
            f"({2 * cfg.vae.latent_channels}-channel UNet — "
            f"sd15_ip2p_config; this config has "
            f"{cfg.unet.in_channels})")
    if img2img:
        raise ValueError("edit_image replaces input_image for "
                         "InstructPix2Pix (denoising starts from pure "
                         "noise; edit strength rides the two guidance "
                         "scales)")
    if not do_cfg:
        raise ValueError("InstructPix2Pix needs do_cfg=True (dual "
                         "text/image guidance)")
    bad = [n for n, v in [("mask_image", mask_image), ("control_image", control_image),
                          ("adapter_image", adapter_image)] if v is not None]
    if bad or guidance_rescale:
        bad += ["guidance_rescale"] if guidance_rescale else []
        raise ValueError(f"InstructPix2Pix does not compose with {'/'.join(bad)}")
    if edited:
        raise ValueError("InstructPix2Pix does not compose with "
                         "PAG/SAG/AND/prompt-editing (its three "
                         "guidance lanes replace the CFG stack)")


def _hints(images, width: int, height: int, batch: int) -> np.ndarray:
    """ControlNet / T2I-Adapter images (one a net) -> (N, B, 3, H, W)
    float32 in [0, 1], the hint convention."""
    return np.stack([np.broadcast_to(rescale(_prepare_image(im, width, height), (-1.0, 1.0),
                                             (0.0, 1.0)), (batch, 3, height, width))
                     for im in images])


def _per_net(models, name: str, images, scales, what: str):
    """The nets of ``models[name]`` (a module or a list), with one image
    and one scale each, as the JAX package checks them (``what``: how its
    messages name the images, the scales and the nets)."""
    nets = _listed(models[name])
    imgs = list(images) if isinstance(images, (list, tuple)) else [images]
    image_word, scale_word, nets_word = what
    if len(imgs) != len(nets):
        raise ValueError(f"{len(imgs)} {image_word} images for {len(nets)} {nets_word}")
    scales = list(scales) if isinstance(scales, (list, tuple)) else [scales] * len(nets)
    if len(scales) != len(nets):
        raise ValueError(f"{len(scales)} {scale_word} scales for {len(nets)} {nets_word}")
    return nets, imgs, scales


def _check_reference(cfg: SDConfig, *, edited: bool, ip2p: bool, inpaint, fixed_noise,
                     fidelity: float, mode: str, deepcache=None) -> str:
    """Reference-only's ValueErrors, as in the JAX package (``edited``: PAG,
    SAG, AND or prompt edits); -> the mode, "attn+adain" written
    "adain+attn"."""
    if edited or ip2p:
        raise ValueError("reference_image does not compose with "
                         "PAG/SAG/AND/prompt-editing/InstructPix2Pix")
    if deepcache is not None:
        raise ValueError("reference_image does not compose with "
                         "deepcache (the attention bank needs the "
                         "full UNet every step)")
    if inpaint == "unet9":
        raise ValueError("reference_image is not supported with "
                         "9-channel inpaint checkpoints")
    if cfg.unet.tome is not None:
        raise ValueError("reference_image does not compose with ToMe "
                         "(merged tokens cannot bank reference "
                         "states)")
    if cfg.unet.hypertile is not None:
        raise ValueError("reference_image does not compose with "
                         "hypertile (tile-local attention cannot "
                         "bank full-grid reference states)")
    if fixed_noise is not None:
        raise ValueError("reference_image is not supported in "
                         "fixed_noise parity mode")
    if not 0.0 <= float(fidelity) <= 1.0:
        raise ValueError("reference_fidelity must be in [0, 1], got "
                         f"{fidelity}")
    if mode not in ("attn", "adain", "adain+attn", "attn+adain"):
        raise ValueError("reference_mode must be 'attn', 'adain' or "
                         f"'adain+attn', got {mode!r}")
    return "adain+attn" if "+" in mode else mode


def encode_image(models, image: torch.Tensor, noise: torch.Tensor, cfg: SDConfig, *,
                 encode_tile: Optional[int] = None) -> torch.Tensor:
    """(B, 3, H, W) pixels in [-1, 1] -> scaled latents (B, 4, h, w) in the
    compute dtype, through the whole or the tiled encoder: every encode of a
    request (img2img's init image, inpainting's masked image) goes through
    here."""
    vae_kw = dict(attention_backend=cfg.vae_attention_backend,
                  reference_quirks=cfg.reference_quirks)
    if encode_tile:
        return vae_mod.apply_encoder_tiled(models["encoder"], image, noise, cfg.policy,
                                           tile=encode_tile, **vae_kw)
    return models["encoder"](image, noise, cfg.policy, **vae_kw)


def _panorama_plan(cfg: SDConfig, height: int, width: int, window: int,
                   stride: Optional[int], *, composed: bool, deepcache, fixed_noise,
                   sequence_parallel: bool = False):
    """MultiDiffusion's window sweep over a canvas larger than the model's
    native size (Bar-Tal et al. 2023; diffusers' panorama pipeline): ->
    (window, ys, xs) in latent pixels, the windows in row-major order, each
    axis's last window flush with the canvas's edge; the JAX package's
    ValueErrors (``composed``: a side net, inpainting, InstructPix2Pix,
    PAG, SAG, AND or prompt editing)."""
    if composed:
        raise ValueError("panorama composes only with the plain "
                         "txt2img/img2img path (no ControlNet/"
                         "T2I-Adapter/reference/ip2p/inpaint/PAG/SAG/"
                         "AND/prompt-editing)")
    if deepcache is not None:
        raise ValueError("panorama does not compose with deepcache")
    if sequence_parallel:
        raise ValueError("panorama does not compose with "
                         "sequence_parallel")
    if fixed_noise is not None:
        raise ValueError("panorama is not supported in fixed_noise "
                         "parity mode")
    factor = cfg.vae.downsample_factor
    if window % factor or window <= 0:
        raise ValueError(f"panorama_window must be a positive "
                         f"multiple of {factor}")
    stride_px = stride or window // 2
    if stride_px % factor or stride_px <= 0:
        raise ValueError(f"panorama_stride must be a positive "
                         f"multiple of {factor}")
    win, step = window // factor, stride_px // factor
    h_lat, w_lat = height // factor, width // factor
    if h_lat < win or w_lat < win:
        raise ValueError(f"canvas {height}x{width} smaller than the "
                         f"panorama window {window}")
    ys, xs = zip(*[(y, x) for y in _window_starts(h_lat, win, step)
                   for x in _window_starts(w_lat, win, step)])
    return win, ys, xs


def _window_starts(total: int, win: int, step: int):
    """The offsets of windows of ``win`` over ``total`` at ``step``, the last
    one flush with the end (the panorama's and the frame windows' sweep)."""
    starts = list(range(0, total - win + 1, step))
    if starts[-1] != total - win:
        starts.append(total - win)
    return starts


# ------------------------------------------------- the request's device work
# What a request runs on the device, as functions of tensors: the once-a-
# request work (:func:`prepare`), one guided UNet evaluation
# (:func:`guided_eps`) and the decode (:func:`decode`).  ``generate`` calls
# them eagerly and ``utils/aot.py`` exports them, so that both run the same
# code; the denoise loop around the evaluations stays on the host (``_sample``
# and ``sampling/``).
def _memory_format(device) -> torch.memory_format:
    """The layout of a request's images and latents: channels_last on the
    card (K5 and the convs read NHWC), NCHW on the CPU."""
    return torch.channels_last if torch.device(device).type == "cuda" \
        else torch.contiguous_format


def _listed(m) -> list:
    """A side-net entry of the models dict (a module or a list) as a list."""
    return list(m) if isinstance(m, (list, tuple)) else [m]


@dataclasses.dataclass(frozen=True)
class Prep:
    """The static modes of a request's once-a-request device work
    (:func:`prepare`): ``n_lanes`` CFG lanes (the AND parts and the uncond
    lane; 1 without CFG), whether the init image is encoded (pixel img2img),
    InstructPix2Pix, the inpainting mode, the hypernetwork's (activation,
    activate_output) and the tiled encoder's tile."""

    cfg: SDConfig
    batch: int
    n_lanes: int
    img2img: bool = False
    ip2p: bool = False
    inpaint: Optional[str] = None
    hyper: Optional[tuple] = None
    encode_tile: Optional[int] = None


def prepare(p: Prep, models, x: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """A request's once-a-request device work, from the tensors ``x`` (made
    by :func:`_prep_inputs`): "tokens" and "weights" (emphasis) -> the
    context "ctx" and SDXL's added conditioning "add" (with "size_emb"),
    three lanes for InstructPix2Pix, through the hypernetwork (strength
    "hyper_strength"); the init image's latents "lat0" ("image",
    "encoder_noise"); InstructPix2Pix's edit-image channels "ip2p_extra";
    the 9-channel UNet's "inpaint_extra" ("mask", "mask_lat",
    "mask_encoder_noise"); each ControlNet's hint features "hints"; the
    T2I-Adapters' scaled sum "adapter_single" and its lanes "adapter"
    ("adapter_hints", "adapter_scale"); the IP-Adapter's image tokens
    "ip_tokens" ("ip_image")."""
    cfg, batch, policy = p.cfg, p.batch, p.cfg.policy
    cd = policy.compute_dtype
    mf = _memory_format(x["tokens"].device)
    vae_kw = dict(attention_backend=cfg.vae_attention_backend,
                  reference_quirks=cfg.reference_quirks)

    def lanes(v):
        return torch.cat([v] * p.n_lanes) if p.n_lanes > 1 else v

    context, add_cond = _encode_prompts(models, x["tokens"], x.get("weights"), cfg,
                                        x.get("size_emb"))
    if p.ip2p:
        # InstructPix2Pix's three lanes: [text + image, image only (the
        # uncond text), unconditional]
        context = torch.cat([context, context[batch:]])
        add_cond = None if add_cond is None else torch.cat([add_cond, add_cond[batch:]])
    if p.hyper is not None:
        # the hypernetwork transforms the whole CFG batch's context, k and v
        # apart, once a request; the (ctx_k, ctx_v) pair rides through every
        # cross-attention (ops/attention.apply)
        from .weights import hypernetwork as hyper_mod

        context = hyper_mod.apply_hypernetwork(
            models["hypernetwork"], context, x["hyper_strength"], activation=p.hyper[0],
            activate_output=p.hyper[1])
    out = {"ctx": context}
    if add_cond is not None:
        out["add"] = add_cond
    image = x.get("image")
    if p.img2img:
        out["lat0"] = encode_image(models, image, x["encoder_noise"], cfg,
                                   encode_tile=p.encode_tile).float()
    if p.ip2p:
        # the edit image's latents: the encoder's mode (zero noise) and, a
        # published quirk of the family, not multiplied by the latent scale
        # factor, so the encoder's x scale_factor is divided out; zeros in
        # the unconditional lane
        f = cfg.vae.downsample_factor
        zeros = torch.zeros((batch, cfg.vae.latent_channels, image.shape[2] // f,
                             image.shape[3] // f), dtype=torch.float32, device=image.device)
        img_lat = models["encoder"](image, zeros, policy, **vae_kw).float() \
            / cfg.vae.scale_factor
        out["ip2p_extra"] = torch.cat([img_lat, img_lat, torch.zeros_like(img_lat)]).to(cd)
    if p.inpaint == "unet9":
        # conditioning channels: the nearest-downsampled mask and the latents
        # of the masked image (the repaint region zeroed)
        binm = (x["mask"] > 0.5).to(image.dtype)
        masked = (image * (1.0 - binm)).contiguous(memory_format=mf)
        masked_lat = encode_image(models, masked, x["mask_encoder_noise"], cfg,
                                  encode_tile=p.encode_tile)
        out["inpaint_extra"] = torch.cat([x["mask_lat"].to(cd), masked_lat.to(cd)], dim=1)
    # slice E, once a request: hint features, adapter features, IP tokens;
    # every one lane-matched for CFG (and AND)
    if "hints" in x:
        out["hints"] = [lanes(net.encode_hint(x["hints"][ci].contiguous(memory_format=mf),
                                              policy))
                        for ci, net in enumerate(_listed(models["controlnet"]))]
    if "adapter_hints" in x:
        feats = None
        for ai, ad in enumerate(_listed(models["t2i_adapter"])):
            fs = [f * x["adapter_scale"][ai].to(f.dtype) for f in ad(
                x["adapter_hints"][ai].contiguous(memory_format=mf), policy)]
            feats = fs if feats is None else [a + b for a, b in zip(feats, fs)]
        # PAG's and SAG's single-lane evaluations take the features as they
        # are, the main one lane-matched
        out["adapter_single"] = feats
        out["adapter"] = [lanes(f) for f in feats]
    if "ip_image" in x:
        ipa, tower = models["ip_adapter"], models["clip_vision"]
        px = x["ip_image"].to(cd).contiguous(memory_format=mf)
        tokens = ipa.image_tokens(tower, px, policy)
        if p.n_lanes > 1:
            tokens = torch.cat([tokens] * (p.n_lanes - 1) + [ipa.negative_tokens(tower, px,
                                                                                 policy)])
        out["ip_tokens"] = tokens
    return out


def _prep_inputs(device, batch: int, *, tokens, weights=None, size_emb=None, pixels=None,
                 noise=None, mask=None, mask_lat=None, hints=None, adapter_hints=None,
                 adapter_scale=None, ip_image=None, hyper_strength=None):
    """The host's inputs of :func:`prepare` on ``device``: ``tokens`` (and
    the emphasis ``weights``) of the whole CFG batch, SDXL's ``size_emb``,
    the ``pixels`` to encode ((1|B, 3, H, W) in [-1, 1]) with the encoders'
    draws of ``noise``, the inpainting ``mask`` ((B, H, W, 1)) and its
    nearest-downsampled ``mask_lat``, the ControlNet and T2I-Adapter
    ``hints`` ((N, B, 3, H, W) in [0, 1]) with ``adapter_scale``, the
    CLIP-preprocessed ``ip_image`` ((1|B, S, S, 3)) and the hypernetwork's
    strength."""
    def dev(v):
        return _to_device(torch.from_numpy(np.array(v, np.float32)), device)

    x = {"tokens": _to_device(torch.as_tensor(tokens), device)}
    if weights is not None:
        x["weights"] = _to_device(torch.as_tensor(weights), device)
    if size_emb is not None:
        x["size_emb"] = _to_device(size_emb, device)
    if hyper_strength is not None:
        x["hyper_strength"] = torch.full((), float(hyper_strength), dtype=torch.float32,
                                         device=device)
    if pixels is not None:
        x["image"] = _to_device(torch.as_tensor(pixels), device).expand(batch, -1, -1, -1) \
            .contiguous(memory_format=_memory_format(device))
    for name in ("encoder", "mask_encoder"):
        if noise is not None and name in noise:
            x[f"{name}_noise"] = noise[name]
    if mask is not None:
        x["mask"] = _to_device(_nchw(mask), device)
        x["mask_lat"] = _to_device(_nchw(mask_lat), device)
    if hints is not None:
        x["hints"] = dev(hints)
    if adapter_hints is not None:
        x["adapter_hints"], x["adapter_scale"] = dev(adapter_hints), dev(adapter_scale)
    if ip_image is not None:
        x["ip_image"] = dev(np.broadcast_to(ip_image, (batch,) + ip_image.shape[1:])
                            .transpose(0, 3, 1, 2))
    return x


@dataclasses.dataclass(frozen=True)
class Guidance:
    """The static modes of one guided UNet evaluation (:func:`guided_eps`):
    the CFG batch of ``n_and`` conditional lanes (the AND parts) and the
    unconditional one (one lane without CFG; InstructPix2Pix's three),
    AnimateDiff's ``n_frames``, PAG's and SAG's extra passes."""

    cfg: SDConfig
    batch: int
    do_cfg: bool = True
    n_and: int = 1
    ip2p: bool = False
    pag: bool = False
    sag: bool = False
    n_frames: Optional[int] = None

    @property
    def n_lanes(self) -> int:
        return self.n_and + 1 if self.do_cfg else 1


def _unet_eval(unet, row_split, x, *args, **kw):
    """One UNet evaluation; under sequence parallelism (``row_split``) on
    the rank's rows of ``x``, the output's rows gathered (SAG's map comes
    whole, DeepCache's feature stays the rank's rows)."""
    if row_split is None:
        return unet(x, *args, **kw)
    with mesh_mod.split_rows(row_split):
        out = unet(_local(x, row_split), *args, **kw)
    if out is None:
        return None
    if isinstance(out, tuple):
        return (mesh_mod.gather_rows(out[0], row_split),) + out[1:]
    return mesh_mod.gather_rows(out, row_split)


def _local(x, row_split):
    """The rank's latent rows of a whole feature (sequence parallelism)."""
    if row_split is None:
        return x
    return mesh_mod.local_rows(x, row_split).contiguous(memory_format=_memory_format(x.device))


def guided_eps(g: Guidance, models, lat: torch.Tensor, t: torch.Tensor,
               x: Dict[str, object], *, row_split=None, main_eval=None,
               extra_side=None) -> torch.Tensor:
    """The guided epsilon of the float32 latents ``lat`` at the 0-d
    timestep tensor ``t`` (a v-prediction model's output turned into
    epsilon): one evaluation of the CFG stack, with its side inputs ``x``
    (:func:`_eval_inputs`: the context "ctx" (a hypernetwork's pair) and
    "add", the inpainting and InstructPix2Pix channels, the ControlNets'
    hint features and scales, the adapter features, the IP tokens and scale,
    the guidance scales, LCM's "t_cond", and "coef", ``ddpm.alpha_coef`` at
    t).
    The combine, in the JAX package's order: AND (and its regions) or CFG
    with guidance rescale, PAG, the conversion to epsilon, SAG.

    The host's floats ("cfg_scale", "image_scale", "coef") may be Python
    numbers or 0-d CPU tensors, which give the same bits.  Eager requests
    also pass ``row_split`` (sequence parallelism), ``main_eval(model_in,
    ctx, t, main)`` for the main pass (DeepCache, the frame and panorama
    windows) and ``extra_side`` (reference-only's read)."""
    cfg, batch, do_cfg = g.cfg, g.batch, g.do_cfg
    policy, cd = cfg.policy, cfg.policy.compute_dtype
    mf = _memory_format(lat.device)
    unet = models["diffusion"]
    cfg_scale = x["cfg_scale"]

    def lanes(v):
        return torch.cat([v] * g.n_lanes) if g.n_lanes > 1 else v

    def unet_eval(inp, *args, **kw):
        return _unet_eval(unet, row_split, inp, *args, **kw)

    lat_in = lat.to(cd)
    inpaint_extra = x.get("inpaint_extra")
    if inpaint_extra is not None:
        # [latents, mask, masked-image latents] (diffusers' order)
        lat_in = torch.cat([lat_in, inpaint_extra], dim=1)
    if g.ip2p:
        # three lanes, each with its edit-image channels appended
        model_in = torch.cat([torch.cat([lat_in] * 3), x["ip2p_extra"]], dim=1)
    else:
        model_in = lanes(lat_in)
    ctx, add = x["ctx"], x.get("add")
    kw = dict(attention_backend=cfg.attention_backend,
              reference_quirks=cfg.reference_quirks, fuse_qkv=cfg.fuse_qkv,
              conv_backend=cfg.conv_backend, t_cond=x.get("t_cond"), modes=cfg.unet,
              quant=cfg.quant)
    if g.n_frames is not None:
        # AnimateDiff: the lanes of each CFG group are the frames
        kw.update(motion=models["motion"], frames=g.n_frames)
    control = None
    if "hints" in x:
        # the ControlNets take the 4-channel latents, whatever the UNet's
        ctrl_in = lanes(lat.to(cd)).contiguous(memory_format=mf)
        for ci, net in enumerate(_listed(models["controlnet"])):
            # the rank's rows of the residuals under sequence parallelism
            with mesh_mod.split_rows(row_split):
                c_i = net(_local(ctrl_in, row_split), ctx, t, x["hints"][ci], policy,
                          conditioning_scale=x["control_scale"][ci],
                          attention_backend=cfg.attention_backend,
                          fuse_qkv=cfg.fuse_qkv, add_cond=add,
                          conv_backend=cfg.conv_backend)
            control = c_i if control is None else {  # residuals sum
                "mid": control["mid"] + c_i["mid"],
                "down": [a + b for a, b in zip(control["down"], c_i["down"])]}
    ip_arg = None
    if "ip_tokens" in x:
        ip_arg = (models["ip_adapter"].layers, x["ip_tokens"], x["ip_scale"])
    side = dict(control=control, adapter=x.get("adapter"), ip=ip_arg)
    side.update(extra_side or {})

    def lane_side(sl):
        """The side inputs of the lanes ``sl`` of the CFG stack (PAG's cond
        lanes, SAG's base lanes): the per-lane IP tokens and ControlNet
        residuals sliced, the adapter features single-lane."""
        out = dict(side, adapter=x.get("adapter_single"))
        if do_cfg and ip_arg is not None:
            out["ip"] = (ip_arg[0], ip_arg[1][sl], ip_arg[2])
        if do_cfg and control is not None:
            out["control"] = {"mid": control["mid"][sl],
                              "down": [d[sl] for d in control["down"]]}
        return out

    main = dict(kw, add_cond=add, **side)
    model_in = model_in.contiguous(memory_format=mf)
    mid_probs = None
    if main_eval is not None:
        eps = main_eval(model_in, ctx, t, main)
    else:
        out = unet_eval(model_in, ctx, t, policy, return_mid_attn=g.sag, **main)
        eps, mid_probs = out if g.sag else (out, None)
    eps = eps.float()
    raw = eps
    if g.pag:
        # the perturbed evaluation: the cond lanes, identity self-attention
        # in the mid block
        cond = slice(None, batch)
        eps_ptb = unet_eval(lat_in.contiguous(memory_format=mf),
                            _lane(ctx, cond) if do_cfg else ctx, t, policy, pag=True, **kw,
                            **lane_side(cond),
                            add_cond=add[cond] if do_cfg and add is not None else add
                            ).float()
    if g.sag:
        # blur x0 of the base lanes (uncond under CFG) where the mid block's
        # attention mass concentrates, re-noise with their epsilon and
        # evaluate them there
        base = slice(batch, None) if do_cfg else slice(None)
        lat32 = lat.float()
        base_eps = ddpm.to_epsilon(None, None, lat32, raw[base], cfg.prediction_type,
                                   coef=x["coef"])
        sa, sb = x["coef"]
        x0 = (lat32 - sb * base_eps) / sa
        # a key's attention mass over the queries, the heads' mean
        mass = mid_probs[base].float().mean(dim=1).sum(dim=1)   # (B, S_mid)
        down = 2 ** (len(cfg.unet.ch_mults) - 1)
        mh, mw = lat.shape[2] // down, lat.shape[3] // down
        from .utils.image import resize

        mask = resize((mass > 1.0).float().reshape(batch, 1, mh, mw),
                      (batch, 1, lat.shape[2], lat.shape[3]), "nearest")
        x0_deg = gaussian_blur(x0) * mask + x0 * (1.0 - mask)
        lat_deg = sa * x0_deg + sb * base_eps
        deg_in = lat_deg.to(cd)
        if inpaint_extra is not None:
            deg_in = torch.cat([deg_in, inpaint_extra], dim=1)
        eps_deg = unet_eval(deg_in.contiguous(memory_format=mf), _lane(ctx, base), t, policy,
                            **kw, **lane_side(base),
                            add_cond=None if add is None else add[base]).float()
        eps_deg = ddpm.to_epsilon(None, None, lat_deg, eps_deg, cfg.prediction_type,
                                  coef=x["coef"])
    if g.ip2p:
        # dual guidance (Brooks et al. 2023, eq. 3)
        e_t, e_i, e_u = eps.chunk(3)
        eps = e_u + cfg_scale * (e_t - e_i) + x["image_scale"] * (e_i - e_u)
    elif g.n_and > 1:
        # composable diffusion: eps_u + cfg Σ w_i (eps_i - eps_u), each
        # weight times its region mask
        parts = eps.chunk(g.n_and + 1)
        eps_u = eps = parts[-1]
        regions = x.get("regions")
        for k in range(g.n_and):
            w_k = x["and_w"][:, k, None, None, None]
            if regions is not None:
                w_k = w_k * regions[k]
            eps = eps + cfg_scale * w_k * (parts[k] - eps_u)
    elif do_cfg:
        eps_cond, eps_uncond = eps.chunk(2)
        eps = eps_uncond + cfg_scale * (eps_cond - eps_uncond)
        if "rescale" in x:
            # "Common Diffusion Noise Schedules and Sample Steps are Flawed",
            # eq. 15-16: the std pulled back toward the conditional one's, in
            # model-output space (ddof 0)
            dims = tuple(range(1, eps.dim()))
            std_c = eps_cond.std(dim=dims, correction=0, keepdim=True)
            std_g = eps.std(dim=dims, correction=0, keepdim=True)
            rescaled = eps * (std_c / torch.clamp(std_g, min=1e-12))
            eps = x["rescale"][0] * rescaled + x["rescale"][1] * eps
    if g.pag:
        eps = eps + x["pag_scale"] * ((eps_cond if do_cfg else raw) - eps_ptb)
    eps = ddpm.to_epsilon(None, None, lat, eps, cfg.prediction_type, coef=x["coef"])
    if g.sag:
        eps = eps + x["sag_scale"] * (base_eps - eps_deg)
    return eps


def _eval_inputs(g: Guidance, prep: Dict[str, object], device, *, cfg_scale,
                 image_scale=1.5, control_scale=None, ip_scale=None, pag_scale=None,
                 sag_scale=None, guidance_rescale: float = 0.0, and_w=None,
                 regions=None, t_cond=None) -> Dict[str, object]:
    """:func:`guided_eps`'s side inputs of a request: :func:`prepare`'s
    outputs and the request's scales on ``device`` (the guidance scales
    ``cfg_scale`` and ``image_scale`` as given: host floats or 0-d CPU
    tensors)."""
    def dev(v):
        return _to_device(torch.from_numpy(np.array(v, np.float32)), device)

    x = {k: v for k, v in prep.items() if k != "lat0"}
    x.update(cfg_scale=cfg_scale, image_scale=image_scale)
    if control_scale is not None:
        x["control_scale"] = dev(control_scale)
    if ip_scale is not None:
        x["ip_scale"] = dev(ip_scale)
    if g.pag:
        x["pag_scale"] = dev(pag_scale)
    if g.sag:
        x["sag_scale"] = dev(sag_scale)
    if g.do_cfg and guidance_rescale > 0.0:
        x["rescale"] = (dev(guidance_rescale), dev(1.0 - guidance_rescale))
    if and_w is not None:
        x["and_w"] = dev(and_w)
    if regions is not None:
        x["regions"] = _to_device(regions, device)
    if t_cond is not None:
        x["t_cond"] = t_cond
    return x


def decode(cfg: SDConfig, models, latents: torch.Tensor,
           decode_tile: Optional[int] = None) -> torch.Tensor:
    """Final latents (B, 4, h, w) -> uint8 (B, H, W, 3) images on their
    device, through the whole or the tiled decoder: decoded (-1, 1)
    rescaled to (0, 255), clamped, truncated."""
    vae_kw = dict(attention_backend=cfg.vae_attention_backend,
                  reference_quirks=cfg.reference_quirks)
    lat_in = latents.contiguous(memory_format=_memory_format(latents.device))
    if decode_tile:
        images = vae_mod.apply_decoder_tiled(models["decoder"], lat_in, cfg.policy,
                                             tile=decode_tile, **vae_kw)
    else:
        images = models["decoder"](lat_in, cfg.policy, **vae_kw)
    images = rescale(images.float(), (-1.0, 1.0), (0.0, 255.0), clamp=True)
    return images.to(torch.uint8).permute(0, 2, 3, 1)  # truncation


# ---------------------------------------------------------- the host's part
def _sampler_setup(cfg: SDConfig, sampler_name: str, timestep_spacing: str,
                   n_inference_steps: int):
    """-> (schedule, timesteps, plan, stream, n_draws): the noise schedule,
    the sampler's grid, restart's or dpm_fast's plan (else None) and the
    named stream of its noise with its draw count (one a step, op, segment
    or iteration)."""
    schedule = ddpm.make_schedule(
        beta_start=ddpm.REFERENCE_BETA_START if cfg.reference_quirks
        else ddpm.BETA_START, zero_terminal_snr=cfg.zero_terminal_snr)
    if sampler_name in ("lcm", "dpm_fast", "dpm_adaptive") \
            and timestep_spacing != "uniform":
        raise ValueError(f"sampler {sampler_name!r} defines its own timesteps; "
                         "timestep_spacing must be 'uniform'")
    if sampler_name == "lcm":  # the distillation grid
        timesteps = lcm.inference_timesteps(n_inference_steps)
    else:
        timesteps = ddpm.timesteps_for(schedule, timestep_spacing, n_inference_steps,
                                       sdxl=cfg.unet.add_embed_dim is not None)
    # restart and dpm_fast run their own grids; the pipeline's maps the
    # strength to their entry (``start_t``), where img2img noises the latents
    plan, stream, n_draws = None, "sampler", n_inference_steps
    if sampler_name == "restart":
        plan = restart.build_plan(schedule, n_inference_steps)
        stream, n_draws = "restart", plan["n_ops"]
    elif sampler_name == "dpm_fast":
        plan = dpm_fast.build_plan(schedule, n_inference_steps)
        stream, n_draws = "dpm_fast", plan["m"]
    elif sampler_name == "dpm_adaptive":
        stream = "dpm_adaptive"
    return schedule, timesteps, plan, stream, n_draws


def _draw_noise(*, seed, fixed_noise, batch: int, lat_shape, n_steps: int, stream: str,
                n_draws: int, encode: bool, inpaint=None, reference: bool = False,
                variation=None, noise_multiplier=None, first: int = 0):
    """The request's noise on the host, drawn up front: from the named
    streams of ``seed`` ('latent_init', the sampler's ``stream``,
    'encoder_noise' where an init image is ``encode``d, 'mask_encoder_noise'
    or 'inpaint' for inpainting, reference-only's), the samples at their
    indices from ``first``; or the injected ``fixed_noise``.  ``variation``
    (seed, strength) slerps the variation seed's draw in, then
    ``noise_multiplier`` scales the initial noise."""
    if fixed_noise is not None:
        noise = {"latent_init": np.reshape(fixed_noise["latent_init"], (batch,) + lat_shape),
                 "sampler": np.reshape(fixed_noise["sampler_noise"],
                                       (n_steps, batch) + lat_shape)}
        if encode:
            noise["encoder"] = np.reshape(fixed_noise["encoder_noise"], (batch,) + lat_shape)
        if inpaint == "unet9":  # zeros where the injected noise has none
            noise["mask_encoder"] = np.reshape(fixed_noise["mask_encoder_noise"],
                                               (batch,) + lat_shape) \
                if "mask_encoder_noise" in fixed_noise \
                else np.zeros((batch,) + lat_shape, np.float32)
        return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in noise.items()}
    s = 0 if seed is None else int(seed)
    kw = dict(first=first)  # a data rank draws its samples at their indices
    noise = {"latent_init": rng_mod.batch_normal(s, "latent_init", batch, lat_shape, **kw),
             "sampler": rng_mod.step_normals(s, stream, n_draws, batch, lat_shape, **kw)}
    if encode:
        noise["encoder"] = rng_mod.batch_normal(s, "encoder_noise", batch, lat_shape, **kw)
    if inpaint == "unet9":
        noise["mask_encoder"] = rng_mod.batch_normal(s, "mask_encoder_noise", batch,
                                                     lat_shape, **kw)
    elif inpaint == "blend":
        noise["inpaint"] = rng_mod.step_normals(s, "inpaint", n_steps, batch, lat_shape, **kw)
    if reference:
        noise["ref_encoder"] = rng_mod.batch_normal(s, "ref_encoder", batch, lat_shape, **kw)
        noise["ref_noise"] = rng_mod.step_normals(s, "ref_noise", n_steps, batch, lat_shape,
                                                  **kw)
    if variation is not None:
        v_seed, v_strength = variation
        noise["latent_init"] = slerp_noise(
            torch.tensor(v_strength, dtype=torch.float32), noise["latent_init"],
            rng_mod.variation_normal(int(v_seed), batch, lat_shape, **kw))
    if noise_multiplier is not None:
        # A1111's initial-noise multiplier, after the variation slerp
        noise["latent_init"] = noise["latent_init"] \
            * torch.tensor(noise_multiplier, dtype=torch.float32)
    return noise


def _denoise(sampler_name: str, schedule, timesteps, latents: torch.Tensor, noise, eps_at,
             *, start_step: int, plan, eta: float, img2img: bool, inpaint=None,
             lat0=None, m_lat=None) -> torch.Tensor:
    """The denoise loop (:func:`_sample`) from ``start_step``; with
    latent-blend inpainting the original latents ``lat0`` re-noised to each
    step's level (the 'inpaint' draws, or under injected noise the
    sampler's) and pasted outside the latent mask ``m_lat`` at the top of
    every step, and exactly at the end."""
    blend = None
    if inpaint == "blend":
        blend_noise = noise["inpaint"] if "inpaint" in noise else noise["sampler"]

        def blend(i: int, lat: torch.Tensor) -> torch.Tensor:
            noised0 = ddpm.add_noise(schedule, lat0, int(timesteps[i]), blend_noise[i])
            return m_lat * lat + (1.0 - m_lat) * noised0
    latents = _sample(sampler_name, schedule, timesteps, latents.float(), noise["sampler"],
                      eps_at, start_step=start_step, plan=plan, eta=eta, img2img=img2img,
                      blend=blend)
    if inpaint == "blend":
        # the exact final projection: the kept region is the original
        latents = m_lat * latents + (1.0 - m_lat) * lat0
    return latents


# -------------------------------------------------------------- public API
def _run_generate(prompt, uncond_prompt="", *, mesh=None, **kwargs):
    """-> (images (B, H, W, 3) uint8, final latents (B, 4, h, w) float32) of
    the request, on one device or over ``mesh``'s ranks."""
    if mesh is not None:
        return _run_on_mesh(prompt, uncond_prompt, mesh, kwargs)
    return _generate_local(prompt, uncond_prompt, **kwargs)


def _run_on_mesh(prompt, uncond_prompt, mesh, kwargs):
    """The request over a (data, model) mesh, every rank calling it alike:
    each data rank runs its rows of the batch (its prompts, per-sample
    init images or latents and injected noise; its noise drawn at the
    samples' indices in the whole batch), the batch-wide reductions taken
    over the data group, and the images and latents gathered, so that every
    rank returns the whole batch's.  A model axis > 1 (the models sharded
    by ``parallel/tp.shard_models``) turns ``fuse_qkv`` off, but under
    ``sequence_parallel``, whose model axis splits the latent rows."""
    cfg = kwargs.get("config") or sd15_config()
    if mesh_mod.axis_size(mesh, mesh_mod.MODEL_AXIS) > 1 and cfg.fuse_qkv \
            and not kwargs.get("sequence_parallel"):
        # the projections stay apart over the column-split heads, as the JAX
        # package's pipeline runs them under TP
        kwargs = dict(kwargs, config=dataclasses.replace(cfg, fuse_qkv=False))
    n_data = mesh_mod.axis_size(mesh, mesh_mod.DATA_AXIS)
    prompts = [prompt] if isinstance(prompt, str) else list(prompt)
    n = len(prompts)
    local = mesh_mod.local_batch(n, mesh)
    first = mesh_mod.axis_rank(mesh, mesh_mod.DATA_AXIS) * local
    rows = slice(first, first + local)
    if not isinstance(uncond_prompt, str) and len(uncond_prompt) == n:
        uncond_prompt = list(uncond_prompt)[rows]
    kwargs = dict(kwargs)

    def own_rows(v):  # a 4-D batch of one image or latent for each prompt
        if v is not None and not hasattr(v, "convert") and np.ndim(v) == 4 and len(v) == n:
            return v[rows]
        return v
    for name in ("input_image", "init_latents", "edit_image", "reference_image",
                 "ip_adapter_image"):
        kwargs[name] = own_rows(kwargs.get(name))
    for name in ("control_image", "adapter_image"):  # an image (or batch) for each net
        v = kwargs.get(name)
        if isinstance(v, (list, tuple)):
            kwargs[name] = [own_rows(im) for im in v]
        else:
            kwargs[name] = own_rows(v)
    if kwargs.get("fixed_noise") is not None:
        steps = kwargs.get("n_inference_steps", 50)
        kwargs["fixed_noise"] = {
            k: np.reshape(v, (steps, n, -1))[:, rows] if k == "sampler_noise"
            else np.reshape(v, (n, -1))[rows] for k, v in kwargs["fixed_noise"].items()}
    group = mesh_mod.axis_group(mesh, mesh_mod.DATA_AXIS)
    with mesh_mod.split_batch((group,)):
        outs = _generate_local(prompts[rows], uncond_prompt, _sample_offset=first, _mesh=mesh,
                               **kwargs)

    def gather(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        t = t.to(mesh.device_type).contiguous()
        parts = [torch.empty_like(t) for _ in range(n_data)]
        torch.distributed.all_gather(parts, t, group=group)
        full = torch.cat(parts)
        return full if isinstance(x, torch.Tensor) else full.cpu().numpy()
    return tuple(gather(x) for x in outs)


def _generate_local(prompt, uncond_prompt="", input_image=None,
                    strength: float = 0.8, do_cfg: bool = True,
                    cfg_scale: float = 7.5, sampler_name: str = "ddpm",
                    n_inference_steps: int = 50, models=None,
                    seed: Optional[int] = None, device=None, idle_device=None,
                    tokenizer=None, *, config: Optional[SDConfig] = None,
                    height: int = 512, width: int = 512,
                    fixed_noise: Optional[Dict[str, np.ndarray]] = None,
                    decode_tile: Optional[int] = None,
                    encode_tile: Optional[int] = None,
                    long_prompts: bool = False, emphasis: bool = False,
                    clip_skip: Optional[int] = None,
                    timestep_spacing: str = "uniform", ddim_eta: float = 0.0,
                    hypernetwork=None, hypernetwork_strength: float = 1.0,
                    init_latents=None, original_size=None, crop_coords=(0, 0),
                    target_size=None, mask_image=None, mask_blur: float = 0,
                    edit_image=None, image_guidance_scale: float = 1.5,
                    color_correction: bool = False, control_image=None,
                    controlnet_scale=1.0, adapter_image=None, adapter_scale=1.0,
                    ip_adapter_image=None, ip_adapter_scale: float = 1.0,
                    clip_vision_config=None, reference_image=None,
                    reference_fidelity: float = 0.5, reference_mode: str = "attn",
                    region_masks=None, freeu=None, deepcache: Optional[int] = None,
                    guidance_rescale: float = 0.0, variation_seed: Optional[int] = None,
                    variation_strength: float = 0.0, pag_scale: float = 0.0,
                    sag_scale: float = 0.0, tiling: bool = False,
                    dynamic_threshold: Optional[float] = None,
                    noise_multiplier: Optional[float] = None,
                    tome_ratio: Optional[float] = None, panorama: bool = False,
                    panorama_window: int = 512, panorama_stride: Optional[int] = None,
                    n_frames: Optional[int] = None, motion_window: Optional[int] = None,
                    motion_stride: Optional[int] = None, sequence_parallel: bool = False,
                    progress: bool = False, _device_output: bool = False,
                    _sample_offset: int = 0, _mesh=None):
    """-> (images (B, H, W, 3) uint8, final latents (B, 4, h, w) float32),
    numpy arrays, or with ``_device_output`` tensors left on the device.
    ``_sample_offset``: the index of the first sample in the whole batch
    (a data rank's share); ``_mesh``: the mesh whose data rank this is."""
    del idle_device  # accepted for the reference's signature, as in the JAX package
    cfg = config or sd15_config()
    inpaint = _inpaint_mode(cfg, mask_image, input_image, init_latents)
    if color_correction:
        if _device_output:
            raise ValueError("color_correction is not supported on the "
                             "async generate_many path")
        if input_image is None:
            raise ValueError("color_correction requires input_image")
    if not 0.0 < strength <= 1.0:
        raise ValueError("strength must be between 0 and 1")
    if sampler_name not in SAMPLERS:
        raise ValueError(f"Unknown sampler value {sampler_name!r}")
    if models is None or tokenizer is None:
        raise ValueError("models dict and tokenizer are required")
    if clip_skip is not None:
        cfg = with_clip_skip(cfg, int(clip_skip))
    if tome_ratio is not None:
        # ToMe token merging (ops/tome.py), a static plan of the config
        cfg = with_tome(cfg, float(tome_ratio))
    if freeu is not None and freeu is not False:
        # FreeU: True = the family's published defaults, or (b1, b2, s1, s2)
        cfg = with_freeu(cfg, True if freeu is True else tuple(freeu))
    check_ported(cfg)
    h_lvl1, w_lvl1 = height // cfg.vae.downsample_factor, width // cfg.vae.downsample_factor
    if panorama:
        # the UNet sees only the panorama's windows, never the whole canvas
        # (the JAX package guards the canvas, and refuses wide panoramas)
        h_lvl1 = w_lvl1 = panorama_window // cfg.vae.downsample_factor
    n_lvl1 = h_lvl1 * w_lvl1
    # Hypertile lifts the guard only where its plan tiles level 1 (the JAX
    # package waives it for any hypertile config)
    if n_lvl1 > MAX_VALIDATED_ATTN_TOKENS and unet_mod.block_plans(
            cfg.unet.tome, cfg.unet.hypertile, h_lvl1, w_lvl1)[1] is None:
        untiled = "" if cfg.unet.hypertile is None else (
            f" (hypertile (tile, min_tokens) = {cfg.unet.hypertile} leaves level 1 "
            f"untiled: min_tokens above its {n_lvl1} tokens, no side with a divisor "
            f"from 2 up to the tile, or ToMe merging it instead)")
        raise ValueError(
            f"{height}x{width} needs {n_lvl1}-token global self-attention, "
            f"beyond the validated streamed-kernel scale "
            f"({MAX_VALIDATED_ATTN_TOKENS}); enable hypertile (models/"
            f"config.with_hypertile or the fast preset) or reduce the size{untiled}")
    policy = cfg.policy

    prompts = [prompt] if isinstance(prompt, str) else list(prompt)
    uncond = [uncond_prompt] if isinstance(uncond_prompt, str) else list(uncond_prompt)
    if len(uncond) == 1 and len(prompts) > 1:
        uncond = uncond * len(prompts)
    if len(uncond) != len(prompts):
        raise ValueError("uncond_prompt count must match the prompts")
    batch = len(prompts)
    if n_frames is not None:
        # AnimateDiff: one prompt becomes n_frames lanes, whose motion
        # modules attend across the frame axis
        if "motion" not in models:
            raise ValueError("n_frames given but models has no 'motion' "
                             "entry (weights/animatediff."
                             "load_motion_module)")
        if batch != 1:
            raise ValueError("n_frames animates ONE prompt (got "
                             f"{batch})")
        if int(n_frames) < 2:
            raise ValueError("n_frames must be >= 2")
        n_frames = int(n_frames)
        prompts, uncond, batch = prompts * n_frames, uncond * n_frames, n_frames

    # prompt editing/alternation: the K distinct realizations of the prompts
    # ride flattened into the encoding batch (K*B), and each step indexes its
    # conditioning from the stack with the host-side map
    sched_idx = None
    if any(prompt_schedule.has_schedule(t) for t in prompts + uncond):
        realized, sched_idx = prompt_schedule.schedule_prompts(
            prompts, uncond, n_inference_steps)
        if len(realized) > 1:
            if fixed_noise is not None:
                raise ValueError("prompt editing is not supported in "
                                 "fixed_noise parity mode")
            prompts = [p for cp, _ in realized for p in cp]
            uncond = [u for _, up in realized for u in up]
        else:  # the syntax resolved to a single conditioning
            prompts, uncond = list(realized[0][0]), list(realized[0][1])
            sched_idx = None
    # composable diffusion ("a cat AND a dog:0.8"): every prompt splits into
    # the same number of parts; the UNet runs n_and cond lanes (part-major)
    # and the uncond lanes, combined eps_u + cfg Σ w_i (eps_i - eps_u)
    n_and, and_w = 1, None
    if any(prompt_schedule.has_composable(p) for p in prompts):
        if sched_idx is not None:
            raise ValueError("AND does not compose with prompt "
                             "editing/alternation")
        if not do_cfg:
            raise ValueError("AND (composable diffusion) requires do_cfg")
        split = [prompt_schedule.split_composable(p) for p in prompts]
        ks = {len(parts) for parts, _ in split}
        if len(ks) != 1:
            raise ValueError("all prompts in a batch must have the same "
                             f"number of AND segments (got {sorted(ks)})")
        n_and = ks.pop()
        if n_and > 1:
            if control_image is not None:
                raise ValueError("AND does not compose with ControlNet")
            if pag_scale or sag_scale:
                raise ValueError("AND does not compose with PAG/SAG")
            if guidance_rescale:
                raise ValueError("AND does not compose with "
                                 "guidance_rescale")
            if fixed_noise is not None:
                raise ValueError("AND is not supported in fixed_noise "
                                 "parity mode")
            and_w = np.asarray([ws for _, ws in split], np.float32)  # (B, n_and)
            prompts = [split[b][0][i] for i in range(n_and) for b in range(batch)]
    # the CFG stack's lanes: n_and cond lanes and the uncond lane
    n_lanes = n_and + 1 if do_cfg else 1
    guided = sched_idx is not None or n_and > 1 or bool(pag_scale) or bool(sag_scale)
    ip2p = edit_image is not None
    if ip2p:
        _check_ip2p(cfg, img2img=input_image is not None or init_latents is not None,
                    do_cfg=do_cfg, mask_image=mask_image, edited=guided,
                    control_image=control_image, adapter_image=adapter_image,
                    guidance_rescale=guidance_rescale)
    elif cfg.unet.in_channels == 2 * cfg.vae.latent_channels:
        raise ValueError(f"an {cfg.unet.in_channels}-channel (InstructPix2Pix) UNet "
                         "needs edit_image")
    # slice E's side nets, checked in the JAX package's order; their host
    # inputs (hints, the CLIP-preprocessed image, the reference pixels)
    nets = adapters = None
    if control_image is not None:
        if "controlnet" not in models:
            raise ValueError("control_image given but models has no "
                             "'controlnet' entry (weights/convert.py "
                             "load_controlnet)")
        nets, control_image, controlnet_scale = _per_net(
            models, "controlnet", control_image, controlnet_scale,
            ("control", "controlnet", "controlnets"))
    if adapter_image is not None:
        if "t2i_adapter" not in models:
            raise ValueError("adapter_image given but models has no "
                             "'t2i_adapter' entry (weights/diffusers.py "
                             "load_t2i_adapter)")
        adapters, adapter_image, adapter_scale = _per_net(
            models, "t2i_adapter", adapter_image, adapter_scale,
            ("adapter", "adapter", "t2i adapters"))
    ip_img = None
    if ip_adapter_image is not None:
        from .models import clip_vision as cv_mod

        if "ip_adapter" not in models:
            raise ValueError("ip_adapter_image given but models has no "
                             "'ip_adapter' entry "
                             "(weights/ip_adapter.load_ip_adapter)")
        if "clip_vision" not in models:
            raise ValueError("ip_adapter_image given but models has no "
                             "'clip_vision' entry "
                             "(weights/ip_adapter.load_clip_vision)")
        if ip2p:
            raise ValueError("IP-Adapter does not compose with "
                             "InstructPix2Pix")
        # the tower's own config unless another is named (the JAX package
        # defaults to ViT-H/14)
        ip_img = cv_mod.preprocess(ip_adapter_image,
                                   clip_vision_config or models["clip_vision"].cfg)
    mwin = None
    if n_frames is not None:
        if (pag_scale or sag_scale or ip2p or n_and > 1 or sched_idx is not None
                or control_image is not None or adapter_image is not None
                or reference_image is not None or panorama
                or inpaint is not None or deepcache is not None
                or sequence_parallel or region_masks is not None):
            raise ValueError("n_frames (AnimateDiff) composes only with "
                             "the plain txt2img/img2img path in this "
                             "build")
        if fixed_noise is not None:
            raise ValueError("n_frames is not supported in fixed_noise "
                             "parity mode")
    if motion_window is not None:
        # long clips: overlapping frame windows (the community AnimateDiff
        # context scheduler), each frame's eps averaged over its windows
        if n_frames is None:
            raise ValueError("motion_window requires n_frames")
        w_f = int(motion_window)
        if not 2 <= w_f < n_frames:
            raise ValueError(f"motion_window must be in [2, n_frames), "
                             f"got {w_f} for {n_frames} frames")
        if ip_adapter_image is not None or hypernetwork is not None:
            raise ValueError("motion_window does not compose with "
                             "IP-Adapter/hypernetworks (per-frame lane "
                             "slicing)")
        mwin = (w_f, _window_starts(n_frames, w_f, int(motion_stride or max(w_f // 2, 1))))
    regions = None
    if region_masks is not None:
        # regional prompting (Latent Couple): each AND part steers only
        # inside its mask, area-downsampled to the latent grid
        if n_and < 2:
            raise ValueError("region_masks needs an AND prompt (one mask "
                             "per AND segment, e.g. 'a cat AND a dog')")
        if len(region_masks) != n_and:
            raise ValueError(f"{len(region_masks)} region masks for "
                             f"{n_and} AND segments")
        regions = torch.stack([_nchw(mask_to_latent_area(
            _prepare_mask(m, width, height), cfg.vae.downsample_factor))
            for m in region_masks])  # (n_and, 1, 1, h, w)
    pano = None
    if panorama:
        composed = (control_image is not None or adapter_image is not None
                    or reference_image is not None or ip2p or inpaint is not None
                    or pag_scale or sag_scale or n_and > 1 or sched_idx is not None)
        pano = _panorama_plan(cfg, height, width, panorama_window, panorama_stride,
                              composed=bool(composed), deepcache=deepcache,
                              fixed_noise=fixed_noise,
                              sequence_parallel=sequence_parallel)
    if reference_image is not None:
        reference_mode = _check_reference(
            cfg, edited=guided, ip2p=ip2p, inpaint=inpaint, fixed_noise=fixed_noise,
            fidelity=reference_fidelity, mode=reference_mode, deepcache=deepcache)
    if sampler_name in _OWN_GRID:
        # their op/segment grids replace the per-step arrays that the
        # sampler noise, the inpainting blend, the per-step contexts and
        # DeepCache's refresh count key off
        if inpaint is not None:
            raise ValueError(f"sampler {sampler_name!r} does not support "
                             "inpainting")
        if deepcache is not None:
            raise ValueError(f"sampler {sampler_name!r} does not compose "
                             "with deepcache")
        if sched_idx is not None:
            raise ValueError(f"sampler {sampler_name!r} does not compose "
                             "with prompt editing/alternation")
        if fixed_noise is not None:
            raise ValueError(f"sampler {sampler_name!r} is not supported "
                             "in fixed_noise parity mode")
    # A1111 variation seeds: the variation seed's initial noise slerped in
    use_variation = variation_seed is not None and variation_strength != 0.0
    if use_variation:
        if not 0.0 <= variation_strength <= 1.0:
            raise ValueError("variation_strength must be in [0, 1], got "
                             f"{variation_strength}")
        if fixed_noise is not None:
            raise ValueError("variation seeds are not supported in "
                             "fixed_noise parity mode")
    # PAG: one more evaluation of the cond lanes an evaluation
    pag = pag_scale != 0.0
    if pag and fixed_noise is not None:
        raise ValueError("PAG is not supported in fixed_noise parity "
                         "mode")
    # SAG: the mid block's map, one more evaluation of the base lanes
    sag = sag_scale != 0.0
    if sag:
        if fixed_noise is not None:
            raise ValueError("SAG is not supported in fixed_noise parity "
                             "mode")
        if deepcache is not None:
            raise ValueError("SAG needs the mid block every step; it does "
                             "not compose with deepcache")
    # A1111 hypernetwork: ``hypernetwork`` is the loader's metadata
    # (activation, activate_output); the nets ride in models["hypernetwork"]
    hyper = None
    if hypernetwork is not None:
        if "hypernetwork" not in models:
            raise ValueError("hypernetwork metadata given but models has no "
                             "'hypernetwork' entry "
                             "(weights/hypernetwork.load_hypernetwork)")
        if sched_idx is not None:
            raise ValueError("hypernetworks are not supported with prompt "
                             "editing/alternation")
        if str(cfg.unet.d_context) not in models["hypernetwork"].nets:
            raise ValueError(
                f"hypernetwork has no entry for context width {cfg.unet.d_context} "
                f"(has {models['hypernetwork'].widths()})")
        act, act_out = hypernetwork
        hyper = (str(act), bool(act_out))
    if noise_multiplier is not None and fixed_noise is not None:
        raise ValueError("noise_multiplier is not supported in "
                         "fixed_noise parity mode")
    if dynamic_threshold is not None and not 0.0 < float(dynamic_threshold) <= 1.0:
        raise ValueError("dynamic_threshold is a quantile ratio in "
                         f"(0, 1], got {dynamic_threshold}")
    if deepcache is not None:
        deepcache = int(deepcache)
        if deepcache < 1:
            raise ValueError(f"deepcache interval must be >= 1, got "
                             f"{deepcache}")
        unet_mod.deepcache_shape(cfg.unet, 1, 1, 1)  # validates
    cond_tokens, uncond_tokens, cond_w, uncond_w = _tokenize(
        tokenizer, prompts, uncond, cfg.clip.max_len, long_prompts=long_prompts,
        emphasis=emphasis, agree=lambda v: mesh_mod.agree_max(v, _mesh))
    vmax = max(cond_tokens.max(), uncond_tokens.max())
    if vmax >= cfg.clip.vocab_size:
        raise ValueError(f"token id {vmax} >= vocab_size {cfg.clip.vocab_size} "
                         "(tokenizer/config mismatch)")

    factor = cfg.vae.downsample_factor
    if height % factor or width % factor:
        raise ValueError(f"height/width must be multiples of {factor}, "
                         f"got {height}x{width}")
    h_lat, w_lat = height // factor, width // factor
    row_split = None
    if sequence_parallel:
        # the latency mode (parallel/sp.py): every UNet evaluation split
        # over the model axis by latent rows
        n_model = 0 if _mesh is None else mesh_mod.axis_size(_mesh, mesh_mod.MODEL_AXIS)
        if n_model < 2:
            raise ValueError("sequence_parallel needs a mesh with a model "
                             f"axis > 1 (got {n_model})")
        if h_lat % n_model:
            raise ValueError(f"latent height {h_lat} not divisible by model "
                             f"axis {n_model}")
        if cfg.unet.tome is not None:
            raise ValueError("ToMe token merging does not compose with "
                             "sequence_parallel (the spatial shard_map "
                             "needs the full token grid)")
        if cfg.unet.hypertile is not None:
            raise ValueError("Hypertile does not compose with "
                             "sequence_parallel (tile folding needs the "
                             "full token grid, not a spatial shard)")
        if getattr(models.get("diffusion"), "tp_group", None) is not None:
            # the port's own refusal: a rank's heads are not the whole layer
            raise ValueError("sequence_parallel needs the whole UNet on every rank; "
                             "these models are split by tensor parallelism "
                             "(parallel/tp.shard_models)")
        row_split = mesh_mod.model_rows(_mesh, h_lat, w_lat)
        # no K5 (it fetches no halo) and no folded norms, as the JAX
        # package runs its "xla" tier under sequence parallelism
        cfg = dataclasses.replace(cfg, conv_backend="plain")
    lat_shape = (cfg.vae.latent_channels, h_lat, w_lat)
    size_ids = canonical_size_ids(cfg, height, width, original_size, crop_coords,
                                  target_size)
    if init_latents is not None:
        # latent-space img2img: the port's (B|1, 4, h, w) layout
        init_latents = torch.as_tensor(init_latents if isinstance(init_latents, torch.Tensor)
                                       else np.asarray(init_latents, np.float32)).float()
        if init_latents.dim() == 3:
            init_latents = init_latents[None]
        if tuple(init_latents.shape[1:]) != lat_shape \
                or init_latents.shape[0] not in (1, batch):
            raise ValueError(f"init_latents shape {tuple(init_latents.shape)} is not "
                             f"(1 or {batch}, *{lat_shape}) for {height}x{width}")
    img2img = input_image is not None or init_latents is not None
    start_step = ddpm.start_step_for_strength(n_inference_steps, strength) \
        if img2img else 0

    schedule, timesteps, plan, stream, n_draws = _sampler_setup(
        cfg, sampler_name, timestep_spacing, n_inference_steps)
    entry_ts = timesteps if plan is None else plan["start_t"]

    # the pixels the request encodes (img2img's and inpainting's init image,
    # InstructPix2Pix's edit image; zeros for inpainting from text) and the
    # inpainting mask, (B|1, H, W, 1) in [0, 1], blurred by ``mask_blur``
    pixels = None
    if input_image is not None:
        pixels = _prepare_image(input_image, width, height)
    elif ip2p:
        pixels = _prepare_image(edit_image, width, height)
    elif inpaint == "unet9":
        pixels = np.zeros((1, 3, height, width), np.float32)
    if pixels is not None and pixels.shape[0] not in (1, batch):
        raise ValueError(f"{pixels.shape[0]} init images for a batch of {batch}: "
                         f"give one image, or one for each prompt")
    mask = None
    if inpaint is not None:
        mask = np.ones((1, height, width, 1), np.float32) if mask_image is None \
            else _prepare_mask(mask_image, width, height)
        if mask_blur:
            # A1111 mask blur: gaussian-soften the repaint boundary
            from .utils.annotators import blur

            mask = np.clip(blur(mask[0, ..., 0], sigma=float(mask_blur)),
                           0.0, 1.0)[None, ..., None].astype(np.float32)
        mask = np.broadcast_to(mask, (batch, height, width, 1))

    if device is None:
        device = next(models["diffusion"].parameters()).device
    device = torch.device(device)
    for m in models.values():
        for net in _listed(m):
            net.to(device)

    # ---- noise: drawn up front on the host, copied to the device once
    noise = _draw_noise(seed=seed, fixed_noise=fixed_noise, batch=batch, lat_shape=lat_shape,
                        n_steps=n_inference_steps, stream=stream, n_draws=n_draws,
                        encode=input_image is not None, inpaint=inpaint,
                        reference=reference_image is not None,
                        variation=(variation_seed, variation_strength) if use_variation
                        else None, noise_multiplier=noise_multiplier, first=_sample_offset)
    noise = {k: _to_device(v, device) for k, v in noise.items()}

    # every training timestep, on the device once: the loops index it with
    # host ints, so no step copies a timestep to the device
    t_all = torch.arange(schedule.num_train_timesteps, dtype=torch.float32, device=device)
    memory_format = _memory_format(device)
    vae_kw = dict(attention_backend=cfg.vae_attention_backend,
                  reference_quirks=cfg.reference_quirks)

    def dev(x):
        return _to_device(torch.from_numpy(np.array(x, np.float32)), device)

    def local(x):
        return _local(x, row_split)

    # seamless tiling: every conv of the request wraps (cleared on the way
    # out, also when the request raises)
    with torch.inference_mode(), conv_ops.circular_padding(bool(tiling)), \
            quant_mod.weight_cache():
        # ---- once a request: one CLIP call for cond and uncond, every
        # window, every realization of an edited prompt and every AND part;
        # the encodes and slice E's side-net features
        tokens = np.concatenate([cond_tokens, uncond_tokens]) if do_cfg else cond_tokens
        weights = None
        if emphasis:
            weights = np.concatenate([cond_w, uncond_w]) if do_cfg else cond_w
        prep = Prep(cfg, batch, n_lanes, img2img=input_image is not None, ip2p=ip2p,
                    inpaint=inpaint, hyper=hyper, encode_tile=encode_tile)
        prepared = prepare(prep, models, _prep_inputs(
            device, batch, tokens=tokens, weights=weights,
            size_emb=None if cfg.unet.add_embed_dim is None
            else _size_embedding(cfg, height, width, size_ids),
            pixels=pixels, noise=noise, mask=mask if inpaint == "unet9" else None,
            mask_lat=None if inpaint != "unet9"
            else mask_to_latent_nearest(mask, cfg.vae.downsample_factor),
            hints=None if nets is None else _hints(control_image, width, height, batch),
            adapter_hints=None if adapters is None
            else _hints(adapter_image, width, height, batch),
            adapter_scale=adapter_scale, ip_image=ip_img,
            hyper_strength=None if hyper is None else hypernetwork_strength))
        context, add_cond = prepared["ctx"], prepared.get("add")
        if sched_idx is not None:  # (K, [2]B, ...): cond then uncond per K
            def per_k(x):
                return torch.cat(x.unflatten(0, (-1, batch)).chunk(2 if do_cfg else 1), dim=1)

            context = per_k(context)
            add_cond = None if add_cond is None else per_k(add_cond)

        lat0 = None
        if init_latents is not None:
            lat0 = init_latents.to(device) if init_latents.is_cuda \
                else _to_device(init_latents, device)
            latents = ddpm.add_noise(schedule, lat0.expand(batch, -1, -1, -1),
                                     int(entry_ts[start_step]), noise["latent_init"])
        elif img2img:
            lat0 = prepared["lat0"]
            latents = ddpm.add_noise(schedule, lat0, int(entry_ts[start_step]),
                                     noise["latent_init"])
        else:
            latents = noise["latent_init"]
        cd = policy.compute_dtype
        m_lat = None
        if inpaint == "blend":
            # the soft (area-mean) latent mask keeps the seam smooth
            m_lat = _to_device(_nchw(mask_to_latent_area(mask, cfg.vae.downsample_factor)),
                               device)

        # ---- a guided evaluation's inputs: the side nets' features (the
        # rank's rows under sequence parallelism), slice F's per-request
        # tensors (the guidance scales, the AND weights and region masks)
        guide = Guidance(cfg, batch, do_cfg, n_and, ip2p=ip2p, pag=pag, sag=sag,
                         n_frames=n_frames)
        t_cond = None
        if cfg.unet.time_cond_dim:
            # LCM's embedded guidance: the distilled UNet takes w = cfg_scale - 1
            # through its cond_proj (usually with do_cfg=False)
            t_cond = _to_device(unet_mod.guidance_scale_embedding(
                torch.tensor(cfg_scale, dtype=torch.float32) - 1.0,
                cfg.unet.time_cond_dim), device)
        ev = _eval_inputs(guide, prepared, device, cfg_scale=cfg_scale,
                          image_scale=image_guidance_scale,
                          control_scale=None if nets is None else controlnet_scale,
                          ip_scale=None if ip_img is None else ip_adapter_scale,
                          pag_scale=pag_scale, sag_scale=sag_scale,
                          guidance_rescale=guidance_rescale, and_w=and_w, regions=regions,
                          t_cond=t_cond)
        for name in ("hints", "adapter", "adapter_single"):
            if name in ev:
                ev[name] = [local(f) for f in ev[name]]
        ref_lat0 = None
        if reference_image is not None:
            ref_px = dev(np.broadcast_to(_prepare_image(reference_image, width, height),
                                         (batch, 3, height, width)))
            ref_lat0 = models["encoder"](ref_px.contiguous(memory_format=memory_format),
                                         noise["ref_encoder"], policy, **vae_kw).float()
            ref_fid = dev(reference_fidelity)
            ref_mask = dev(np.repeat([0.0, 1.0], batch)) if do_cfg else None
        dyn_q = None if dynamic_threshold is None else dev(dynamic_threshold)
        unet = models["diffusion"]
        # DeepCache: the deep feature of the last full evaluation, carried
        # across the loop's evaluations
        dc = {"cache": None}

        def window_sweep(model_in, ctx, t, main):
            """The UNet over overlapping windows, one call each, and each
            output element averaged over the windows that hold it, summed
            and counted in fp32, as in the JAX package: AnimateDiff's frame
            windows (``motion_window``; every CFG group's lanes sliced
            alike) or the panorama's spatial ones, in row-major order."""
            spatial = model_in.shape[2:]
            if mwin is not None:
                win, f_starts = mwin
                groups = model_in.shape[0] // n_frames

                def frames(x, f0):  # the window's lanes of every CFG group
                    return x.unflatten(0, (groups, n_frames))[:, f0:f0 + win].flatten(0, 1)

                acc = torch.zeros((groups, n_frames, cfg.unet.out_channels) + spatial,
                                  dtype=torch.float32, device=device)
                cnt = torch.zeros((1, n_frames, 1, 1, 1), dtype=torch.float32, device=device)
                add = main["add_cond"]
                for f0 in f_starts:
                    eps_w = unet(frames(model_in, f0).contiguous(memory_format=memory_format),
                                 frames(ctx, f0), t, policy,
                                 **dict(main, frames=win,
                                        add_cond=None if add is None else frames(add, f0)))
                    acc[:, f0:f0 + win] += eps_w.float().unflatten(0, (groups, win))
                    cnt[:, f0:f0 + win] += 1.0
                return (acc / torch.clamp(cnt, min=1.0)).flatten(0, 1)
            win, ys, xs = pano
            acc = torch.zeros((model_in.shape[0], cfg.unet.out_channels) + spatial,
                              dtype=torch.float32, device=device)
            cnt = torch.zeros((1, 1) + spatial, dtype=torch.float32, device=device)
            for y0, x0 in zip(ys, xs):
                w = (Ellipsis, slice(y0, y0 + win), slice(x0, x0 + win))
                acc[w] += unet(model_in[w].contiguous(memory_format=memory_format), ctx, t,
                               policy, **main).float()
                cnt[w] += 1.0
            return acc / torch.clamp(cnt, min=1.0)

        def eps_at(i: int, lat: torch.Tensor, t: int,
                   refresh: Optional[bool] = None) -> torch.Tensor:
            """The guided epsilon of the latents at training timestep ``t``
            (:func:`guided_eps`); step index ``i`` picks an edited prompt's
            conditioning and, with DeepCache, whether the evaluation is full
            (``(i - start_step) % N == 0``, unless ``refresh`` says; a
            shallow one reads the carried feature).  Reference-only's capture
            pass runs first; dynamic thresholding last."""
            x = ev
            if sched_idx is not None:
                k = int(sched_idx[i])
                x = dict(ev, ctx=context[k], add=None if add_cond is None else add_cond[k])
            else:
                x = dict(ev, ctx=context, add=add_cond)
            x["coef"] = ddpm.alpha_coef(schedule, t)
            ctx, add = x["ctx"], x["add"]
            extra_side = None
            if ref_lat0 is not None:
                # the capture pass: the reference re-noised to t, without the
                # side nets; the main pass reads what it banks
                kw = dict(attention_backend=cfg.attention_backend,
                          reference_quirks=cfg.reference_quirks, fuse_qkv=cfg.fuse_qkv,
                          conv_backend=cfg.conv_backend, t_cond=t_cond, modes=cfg.unet,
                          quant=cfg.quant)
                rn = ddpm.add_noise(schedule, ref_lat0, int(t),
                                    noise["ref_noise"][min(i, len(timesteps) - 1)])
                bank = {} if "attn" in reference_mode else None
                abank = {} if "adain" in reference_mode else None
                _unet_eval(unet, row_split,
                           guide_lanes(rn.to(cd)).contiguous(memory_format=memory_format),
                           ctx, t_all[int(t)], policy, head=False, add_cond=add, **kw,
                           ref=None if bank is None else ("capture", bank),
                           ref_adain=None if abank is None else ("capture", abank))
                extra_side = dict(ref=None if bank is None else ("read", bank, ref_fid,
                                                                 ref_mask),
                                  ref_adain=None if abank is None
                                  else ("read", abank, ref_fid, ref_mask))
            main_eval = None
            if mwin is not None or pano is not None:
                def main_eval(model_in, ctx, tt, main):
                    return window_sweep(model_in, ctx, tt, main).to(cd)
            elif deepcache is not None:
                def main_eval(model_in, ctx, tt, main):
                    if (i - start_step) % deepcache == 0 if refresh is None else refresh:
                        eps, dc["cache"] = _unet_eval(unet, row_split, model_in, ctx, tt,
                                                      policy, return_cache=True, **main)
                        return eps
                    return _unet_eval(unet, row_split, model_in, ctx, tt, policy,
                                      cache=dc["cache"], **main)
            eps = guided_eps(guide, models, lat, t_all[int(t)], x, row_split=row_split,
                             main_eval=main_eval, extra_side=extra_side)
            if dyn_q is not None:
                # dynamic thresholding (Imagen; diffusers' _threshold_sample):
                # clip x0 at its per-sample |x0| quantile s >= 1, rescale by s
                sa, sb = x["coef"]
                l32 = lat.float()
                x0 = (l32 - sb * eps) / sa
                q = torch.quantile(x0.reshape(x0.shape[0], -1).abs(), dyn_q, dim=1)
                q = torch.clamp(q, min=1.0)[:, None, None, None]
                x0 = torch.maximum(torch.minimum(x0, q), -q) / q
                eps = (l32 - sa * x0) / sb
            if progress:  # the steps enqueued: no device sync
                _progress_tick(min(i, n_inference_steps - 1), n_inference_steps)
            return eps

        def guide_lanes(v):
            return torch.cat([v] * n_lanes) if n_lanes > 1 else v

        latents = _denoise(sampler_name, schedule, timesteps, latents, noise, eps_at,
                           start_step=start_step, plan=plan, eta=float(ddim_eta),
                           img2img=img2img, inpaint=inpaint, lat0=lat0, m_lat=m_lat)
        images = decode(cfg, models, latents, decode_tile)
        if _device_output:
            return images, latents
        out = images.cpu().numpy()
        if color_correction:
            # A1111 img2img "apply color correction": histogram-match each
            # output to its init image (host-side post-processing)
            ref = np.broadcast_to(np.clip(rescale(pixels.transpose(0, 2, 3, 1), (-1.0, 1.0),
                                                  (0.0, 255.0)), 0, 255).astype(np.uint8),
                                  out.shape)
            out = np.stack([match_histograms(out[i], ref[i]) for i in range(out.shape[0])])
        return out, latents.cpu().numpy()


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; to a card through pinned memory without
    blocking, so that a request's inputs reach the card without the host
    waiting for the work queued before them (``generate_many``'s chunks)."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _sample(sampler: str, schedule, timesteps: np.ndarray, latents: torch.Tensor,
            noise: torch.Tensor, eps_at, *, start_step: int, plan, eta: float,
            img2img: bool, blend=None) -> torch.Tensor:
    """The denoise loop of ``sampler`` from ``start_step`` (JAX ``pipeline.py``'s
    loops): float32 latents in and out, ``noise`` the sampler stream's
    draws, ``eps_at(i, latents, t)`` one guided UNet evaluation (with
    ``refresh=False`` a DeepCache shallow one: heun's corrector and the dpm2
    family's midpoint, as in the JAX package).  Heun and the dpm2 family
    make no second evaluation on their final (Euler) step, which the JAX
    package evaluates and discards.  ``blend(i, latents)``
    (latent-blend inpainting) runs at the top of every step of the
    pipeline's grid, before its first evaluation; the own-grid samplers
    take none."""
    if blend is None:
        def blend(i, lat):
            return lat
    n = len(timesteps)
    prev_ts = np.append(timesteps[1:], -1)
    steps = [(i, int(timesteps[i]), int(prev_ts[i])) for i in range(start_step, n)]
    if sampler in ("dpm++", "dpm++_sde", "dpm++_3m_sde", "unipc"):
        state = dpm.init_state_3m() if sampler == "dpm++_3m_sde" \
            else unipc.init_state() if sampler == "unipc" else dpm.init_state()
        for i, t, prev in steps:
            latents = blend(i, latents)
            eps = eps_at(i, latents, t)
            if sampler == "dpm++_sde":
                latents, state = dpm.step_sde(schedule, t, latents, eps, noise[i], state,
                                              prev_t=prev)
            elif sampler == "dpm++_3m_sde":
                latents, state = dpm.step_sde_3m(schedule, t, latents, eps, noise[i],
                                                 state, prev_t=prev)
            else:
                latents, state = (unipc if sampler == "unipc" else dpm).step(
                    schedule, t, latents, eps, state, prev_t=prev)
    elif sampler == "plms":
        # n + 1 iterations: the warm-up evaluates the second grid point twice
        state = pndm.init_state()
        for i in range(start_step, n + 1):
            te = min(pndm.eval_index(i, start_step), n - 1)
            latents = blend(te, latents)
            eps = eps_at(te, latents, int(timesteps[te]))
            latents, state = pndm.step(schedule, timesteps, prev_ts, i, start_step,
                                       latents, eps, state, n_steps=n)
    elif sampler == "lms":
        table, hist = lms.coeff_table(schedule, timesteps), []
        for i, t, prev in steps:
            latents = blend(i, latents)
            eps = eps_at(i, latents, t)
            latents, hist = lms.step(schedule, table, i, start_step, t, latents, eps,
                                     hist, prev_t=prev)
    elif sampler in ("heun", "dpm2", "dpm2_a", "dpm++_2s_a"):
        # a second evaluation at the next grid point (heun) or the log-space
        # midpoint (the dpm2 family); none on the final step
        mids = None if sampler == "heun" else dpm2.mid_timesteps(
            schedule, timesteps, ancestral=sampler != "dpm2")
        for i, t, prev in steps:
            latents = blend(i, latents)
            eps = eps_at(i, latents, t)
            if prev < 0:
                latents = euler.step(schedule, t, latents, eps, prev_t=prev)
            elif sampler == "heun":
                pred = euler.step(schedule, t, latents, eps, prev_t=prev)
                # the corrector reuses the deep feature just refreshed
                eps2 = eps_at(i + 1, pred, prev, refresh=False)
                latents = euler.step_heun_correct(schedule, t, latents, eps, eps2,
                                                  prev_t=prev)
            else:
                t_mid = int(mids[i])
                pred_mid = euler.step(schedule, t, latents, eps, prev_t=t_mid)
                eps2 = eps_at(i, pred_mid, t_mid, refresh=False)
                if sampler == "dpm2":
                    latents = euler.step(schedule, t, latents, eps2, prev_t=prev)
                elif sampler == "dpm2_a":
                    latents = dpm2.step_ancestral_second(schedule, t, latents, eps2,
                                                         noise[i], prev_t=prev)
                else:
                    latents = dpm.step_2s_ancestral_second(
                        schedule, t, latents, pred_mid, eps2, t_mid, noise[i], prev_t=prev)
    elif sampler in _OWN_GRID:
        # no prompt editing here: every evaluation takes conditioning 0; an
        # op's or segment's evaluations take the reference noise of step
        # min(i, n - 1), dpm_adaptive's that of step 0, as the JAX package's
        # loops index them
        if sampler == "restart":
            for i in range(int(plan["op_start"][start_step]), plan["n_ops"]):
                latents = restart.run_op(schedule, plan, i, latents, noise[i],
                                         lambda x, t, i=i: eps_at(min(i, n - 1), x, t))
        elif sampler == "dpm_fast":
            for i in range(int(plan["seg_start"][start_step]), plan["m"]):
                latents = dpm_fast.run_segment(schedule, plan, i, latents, noise[i],
                                               lambda x, t, i=i: eps_at(min(i, n - 1), x, t))
        else:
            # txt2img enters at the full sigma_max; img2img at the grid
            # timestep its latents were noised to, at any strength
            t_entry = int(timesteps[min(start_step, n - 1)]) if img2img \
                else schedule.num_train_timesteps - 1
            latents, _ = dpm_adaptive.sample(schedule, latents, t_entry,
                                             lambda x, t: eps_at(0, x, t), noise,
                                             max_iters=n)
    else:
        for i, t, prev in steps:
            latents = blend(i, latents)
            eps = eps_at(i, latents, t)
            if sampler == "ddim":
                latents = ddim.step(schedule, t, latents, eps, noise[i], eta=eta, prev_t=prev)
            elif sampler == "euler":
                latents = euler.step(schedule, t, latents, eps, prev_t=prev)
            elif sampler == "euler_a":
                latents = euler.step_ancestral(schedule, t, latents, eps, noise[i],
                                               prev_t=prev)
            elif sampler == "lcm":
                latents = lcm.step(schedule, t, latents, eps, noise[i], prev_t=prev)
            else:
                latents = ddpm.step(schedule, t, latents, eps, noise[i],
                                    num_inference_steps=n, prev_t=prev)
    return latents


def generate(prompt, uncond_prompt="", **kwargs):
    """Generate one image from text (+ optional init image).

    Returns a uint8 (H, W, 3) numpy image; with ``return_latents=True`` also
    the final (1, 4, h, w) latents."""
    return_latents = kwargs.pop("return_latents", False)
    images, latents = _run_generate(prompt, uncond_prompt, **kwargs)
    if return_latents:
        return images[0], latents
    return images[0]


def generate_images(prompts, uncond_prompts="", **kwargs) -> np.ndarray:
    """Batched generation: list of prompts -> (B, H, W, 3) uint8; one
    batched UNet call per step serves the whole batch (CFG doubles it)."""
    images, _ = _run_generate(list(prompts), uncond_prompts, **kwargs)
    return images


def generate_many(prompts, uncond_prompts="", *, batch_size: int = 4,
                  seed: Optional[int] = None, **kwargs) -> np.ndarray:
    """Serving path: any number of prompts -> (N, H, W, 3) uint8.

    Splits the prompts into ``batch_size`` chunks and runs them back to
    back, every chunk's images left on the device until the last chunk is
    queued: no chunk waits on the host for the one before it, and the
    images come to the host in one copy at the end.

    Chunk seeding: chunk 0 uses the request's seed (so a call that fits in
    one batch bit-matches ``generate_images`` at the same seed), and chunk
    ``k > 0`` the seed of the named 'chunk' stream's draw ``k``
    (``core/rng.chunk_seed``), so distinct seeds never reproduce each
    other's chunks (``seed + k`` would make call(seed=0) chunk 1 equal
    call(seed=1) chunk 0).  The final partial chunk is padded by repeating
    its last prompt, so every chunk has one batch size, and the padding is
    sliced off.  A 4-D ``input_image`` (one init image a prompt) is chunked
    alongside the prompts."""
    prompts = list(prompts)
    uncond = ([uncond_prompts] * len(prompts)
              if isinstance(uncond_prompts, str) else list(uncond_prompts))
    if len(uncond) != len(prompts):
        raise ValueError("uncond_prompts length must match prompts")
    n = len(prompts)
    if n == 0:
        return np.zeros((0, kwargs.get("height", 512), kwargs.get("width", 512), 3),
                        np.uint8)
    per_sample_img = None
    img_arg = kwargs.get("input_image")
    if img_arg is not None and np.ndim(img_arg) == 4:
        per_sample_img = np.asarray(img_arg)
        if len(per_sample_img) != n:
            raise ValueError(f"{len(per_sample_img)} input images for {n} prompts")
    root = 0 if seed is None else int(seed)
    device_outs = []
    for i in range(0, n, batch_size):
        chunk = prompts[i:i + batch_size]
        cu = uncond[i:i + batch_size]
        ckw = dict(kwargs)
        if per_sample_img is not None:
            imgs = per_sample_img[i:i + batch_size]
            if len(imgs) < batch_size:
                pad = np.repeat(imgs[-1:], batch_size - len(imgs), axis=0)
                imgs = np.concatenate([imgs, pad], axis=0)
            ckw["input_image"] = imgs
        while len(chunk) < batch_size:  # pad to keep one batch size
            chunk.append(chunk[-1])
            cu.append(cu[-1])
        images, _ = _run_generate(chunk, cu, seed=rng_mod.chunk_seed(root, i // batch_size),
                                  _device_output=True, **ckw)
        device_outs.append(images)
    return torch.cat(device_outs)[:n].cpu().numpy()
