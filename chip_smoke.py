#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the quickest
proof that the port still builds, starts and answers on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), the torch/CUDA versions, and the SM count and
                maximum SM clock (the exp floor: 16 exp2 a clock on each SM).
  2. build    — build every CUDA kernel of the main paths from the checkout
                with nvcc, all at once: K1 (csrc/flash_attention_bsc.cu),
                K2 (csrc/flash_attention_onepass.cu), K4
                (csrc/flash_attention_streamed.cu), K3
                (csrc/flash_attention_multipass.cu) and K5
                (csrc/scaled_silu_conv3x3.cu); print -Xptxas -v (registers,
                spills) by kernel, the tensor-core template of K1 and K4
                (csrc/flash_attention_tc.cuh) at each head dim included.
  3. kernels  — each kernel against its plain PyTorch version (max abs
                error within 2e-2 for bf16, 1e-4 for fp32, each times the
                reference's largest value where that is below 1 — for K5
                times that value itself; TF32 off for the reference), on
                q/k/v views of one fused projection as the model makes them:
                K1 at the SD-1.5 512² shapes (batch 2 and 8), ragged cases
                (Sq not a multiple of the q tile, Sk not one of the KV
                tile, Dh 40 with 8 packed heads) and the 2048² levels 2
                and 3 and mid block; K4 at the 2048² UNet level 1 (2|8, 8,
                65536, 40), two ragged cases and KV 262144 with 4096 q rows
                (the 4096² level-1 KV); K1 and K4 each in bf16 (the
                tensor-core template) and fp32, K1 also at Dh 64 (5 heads);
                K3 at the VAE mid block (1, 1, 65536|4096, 512) in bf16
                (wgmma) and fp32, causal ragged cases at Dh 64, 128 and
                512, and head dims it pads (80 and 320 over 40960+ KV
                tokens), with its launch configuration; K2 at
                the cross-attentions of a 4-window prompt at 512² (2|8, 8,
                4096|1024|256|64, KV 308, Dh 40|80|160) on views of one
                fused k/v projection and, at batch 2, on k and v in two
                allocations of their own (a hypernetwork's), a ragged KV 300, causal cases across
                64-, 128- and 192-row CTAs, with two q tiles a CTA and with
                Sq < Sk, a KV of 77 tokens and of one, and KV 9216 at Dh
                40, each with the schedule its bf16 launch takes (64-row
                CTAs, K/V resident across a CTA's q tiles, or streamed),
                and at the four level shapes every schedule that can run
                them, timed; slice C2's shapes, all at Dh 64, in bf16 and
                fp32 and timed in bf16: K1 at SDXL 1024² (2, 4096, 640)
                with 10 heads and (2, 1024, 1280) with 20 (also at CFG
                batch 4, generate_many's), the refiner's (2, 4096, 768)
                with 12, (2, 1024, 1536) and (2, 256, 1536) with 24, SD-2.1
                768²'s (2, 9216, 320) with 5, (2, 2304, 640) with 10 and
                (2, 576, 1280) with 20, with a planted fault at SDXL's
                level 1; K2 at those levels under a 4-window prompt (KV
                308); K3 at the 1024² and 768² VAE mid blocks (1|2, 1,
                16384|9216, 512); K4 at Dh 64 over 40960 KV tokens; K5 at
                every res-block conv of SDXL and the refiner at 1024² and
                SD-2.1 at 768² (batch 2, SDXL's also at 4), timed at four;
                slice C3's lane counts and shapes, from the UNet's plan
                (``C3_PLANS``, ``plan_shapes``): K1, K5 at SD-1.5 512² with
                one lane (LCM without CFG) and three (InstructPix2Pix),
                at 1024² (hires_fix's second pass) and on outpaint's
                640x512 canvas, and at SDXL 1024² with one lane; K2 at
                three lanes under a 4-window prompt; K3 at the canvas's
                VAE mid block (5120 tokens); each timed (K5 at each
                request's largest conv); slice E's reference reads, from
                the plan (``E_PLANS``, ``e_shapes``), q and k/v from
                separate projections: K2 over KV = 2·S at SD-1.5 512²
                (2, 8, 4096|1024|256, 8192|2048|512, 40|80|160), 768²
                and SDXL 1024² (2, 10|20, 4096|1024, 8192|2048, 64), and
                K4 with Sq != Sk at 768² (2, 8, 9216, 18432, 40), each
                timed in bf16 beside SDPA and the bound; slice F's K1
                shapes from the plan (``F_PLANS``, ``f_shapes``):
                Hypertile 32's tile batches (8, 1024, 320) at 512²,
                (128|32|8, 1024, 320|640|1280) at 2048², (200|50, 1024,
                320|640) and the ragged (32, 400, 1280) at 2560², SDXL's
                (8, 1024, 640) at 10 heads, and ToMe 0.5's merged lengths
                (2, 2048, 320|640), checked on a subset of q rows where the
                batch is large and timed beside SDPA and the bound; slice
                G's, from the plan (``G_PLANS``, ``g_shapes``; ``G_K3``):
                K1 at AnimateDiff's 32 lanes (16 frames x CFG) (32,
                4096|1024|256, 320|640|1280) on 256 q rows, in bf16 and
                fp32, timed beside SDPA, with the planted fault at level 1;
                K5 at every res-block conv of 32 lanes, the planted fault
                and a time beside cuDNN at (32, 64², 960 -> 320); K3 at the
                VAE mid blocks of slice G's decodes: (1, 1, 131072, 512),
                the 2048x4096 panorama's, with the planted fault, and
                (16|24|4, 1, 4096, 512), in bf16 and fp32, timed beside
                SDPA;
                K5 at
                every (batch, shape) at which phases 4, 6 and 7 run it, from
                the UNet's plan: the 14 distinct res-block conv shapes of
                SD-1.5 512² at batch 2 (with and without the time-embedding
                fold) and 8, those of 2048² and of 128² at batch 2, and a
                ragged case, in bf16 and fp32.  Where the plain version
                would be too slow, correctness is checked on a subset of q
                rows and the kernel is timed at the full shape.  At the main
                K4 and K3 shapes a planted fault (KV short by 4096 tokens),
                at K1's (KV short by one 128-token tile), at K2's (KV short
                by 64 tokens), at K5's the plain
                version with the padding applied before the activation, must
                fail the same check.  Device times under torch.profiler of
                the kernel and, where one PyTorch call computes the same
                function, of that call (scaled_dot_product_attention, with
                the bound and the exp floor beside K1's, K4's, K3's and K2's
                at each level shape; for
                K5 cuDNN's conv on the already activated input, and the
                plain tier's GroupNorm + SiLU + cuDNN conv), used nowhere in
                the port; CUDA-event times of the plain versions.  Where the
                profiler records no kernel three times over, a call of 1 ms
                or more is timed by CUDA events instead (the kernels line
                says which timer each entry's times came from); a shorter
                one fails the run.  K5 also summed over the 44 convs of a
                512² CFG step, its launch configuration and the Cin split it
                takes at each conv shape.
                The host time of one small K1 call, its C function's
                argument types bound once against bound before every
                call.
  4. small    — SD-1.5 at full width, FP32, 128², 3 DDPM+CFG steps: the
                card against the port's CPU plain path on the same seeded
                weights and noise (latents PSNR > 55 dB, uint8 image PSNR
                > 40 dB): once on K1, once with FLASH_ONLY_KV lowered so
                that K4 carries level 1 and vae_attention_backend="kernel"
                so that K3 carries the VAE, once with
                conv_backend="kernel_fold" (K5's fp32 path), and once with a
                4-window prompt (emphasis, BREAK, clip_skip=2) so that K2
                carries every cross-attention; then four sampler loops of
                slice B on K1: dpm++_3m_sde on the Karras grid (4 steps),
                heun, restart, and ddim with eta 0.5 on the zero-terminal-SNR
                schedule and the trailing grid (3 steps); with exact launch
                counts from each sampler's UNet evaluations.
                Slice C2 (``phase_small_c2``, lines ``small C2``): SDXL
                and SD-2.1 768-v at full width, FP32, 256², 1 DDPM+CFG
                step, card against the CPU plain path (> 55 dB latents,
                > 40 dB image): SDXL with K1 at level 1 (256 tokens, Dh 64)
                and K3 in the VAE; SD-2.1 with FLASH_ONLY_KV lowered to 1024
                so that K4 carries level 1 at Dh 64; the CPU side's host
                memory and time printed.
                Slice C3 (``phase_small_c3``, lines ``small C3``): SD-1.5
                at full width, FP32, 256², 2 steps, CFG 5, card against
                the CPU plain path (> 55 dB latents, > 40 dB image, the
                plan's launches): 9-channel inpainting, latent-blend
                inpainting (mask_blur 4), InstructPix2Pix and LCM without
                CFG, each UNet SD-1.5's with its conv_in or cond_proj
                drawn from a seed.
                Slice E (``phase_small_e``, lines ``small E``), on the
                same CPU models: SD-1.5 at full width, FP32, 256², 1
                euler_a step, CFG 5, card against the CPU plain path (>
                55 dB latents, > 40 dB image, the plan's launches): a
                ControlNet, two, the T2I-Adapter, IP-Adapter standard and
                plus (the ViT-H/14 tower at 224²), reference attn and
                adain; every side net drawn from a seed on the CPU (the
                ControlNets' zero convs too) and copied to the card.
                Slice F (``phase_small_f``, lines ``small F``), on the same
                CPU models, 1 dpm++ step (DeepCache 2), the card on the kernel
                attention, conv and VAE: guidance rescale 0.7 with dynamic
                thresholding 0.995, PAG 3, SAG 0.75, AND with two region
                masks, a variation seed with the noise multiplier,
                DeepCache 2, Hypertile 16 and ToMe 0.5 at min_tokens 1024
                (their K1 shapes held to the plan), FreeU and tiling.
                Slice G (``phase_small_g``, lines ``small G``), on the same
                CPU models with SD-1.5's 21 motion modules drawn from a
                seed, 1 dpm++ step, CFG 5, the card on the kernel
                attention, conv and VAE: animate 3 frames, 4 frames through
                windows of 3, and a 256x384 panorama (2 windows).
  5. model    — full-width SD-1.5 (BF16, kernel attention) on the card with
                random weights from a seeded generator; parameter counts.
  6. requests — slice A, generate() at 512²: txt2img 50-step DDPM CFG 7.5
                seed 1337, the same again (bit-identical), seed 1338
                (different), img2img at strength 0.8, generate_images()
                with 4 prompts.  Slice C1, at 2048²: (f) txt2img, 4 steps;
                (g) hires pass: (a) upscaled to 2048², img2img at strength
                0.5 with encode_tile and decode_tile; (h) 512² img2img with
                vae_attention_backend="kernel"; (i) 4096² must raise
                ValueError.  Slice H1, the conv_backend tiers at 512², 20
                steps: (j0) txt2img on "plain", (j) on "kernel", (k) on
                "fold", (l) on "kernel_fold" twice (bit-identical), (m0)
                and (m) generate_images() x4 on "plain" and
                "kernel_fold", (n) img2img at strength 0.8 on "kernel",
                (o) and (p) generate_images() x4 on "kernel" and "fold";
                each one's PSNR against (j0) or (m0) is printed, not gated.
                Slice D1, prompt features at 512², 20 steps: (q) txt2img
                with a 4-window prompt (308 context tokens), emphasis,
                BREAK and clip_skip=2; (r) generate_images() x4 with long
                prompts (CFG batch 8); (s) a prompt edit [..:..:10] in a
                long prompt: K2 at every cross-attention, 16 a UNet
                evaluation.
                Slice B, the samplers at 512² (BF16, batch 1, CFG 7.5, seed
                1337): each of the 17 besides ddpm once, at 10 steps (lcm
                4; dpm_adaptive at most 10 iterations), on the Karras grid
                for dpm++, dpm++_sde, dpm++_3m_sde, euler, heun, dpm2 and
                dpm2_a; img2img at strength 0.6 with dpm++ (Karras) and
                restart; euler_a on conv_backend="kernel" (K5); dpm++ with
                the 4-window prompt (K2); dpm++_sde and dpm_adaptive again
                (bit-identical).  Each request's UNet evaluations are
                counted from its sampler's schedule (n - s, 2(n - s) - 1
                for heun and the dpm2 family, n + 1 - s for plms, 2 an op
                of restart's plan, 3 a segment of dpm_fast's, 3 an
                iteration of dpm_adaptive as its ``sample`` reports them).
                The launch counters are zeroed before each path (each slice
                B request) and every request checks its K1/K2/K3/K4/K5
                launches against the counts derived from the model's plan,
                the context length and the documented dispatch thresholds
                (not from the port's router); at 2048² these
                must also equal the per-step counts PERF.md states, and K5
                must run 44 times a UNet evaluation on "kernel" and
                "kernel_fold", never on "plain" and "fold".
                Slice D (``phase_slice_d``, lines ``D ...``), BF16, kernel
                attention, files in a temporary directory: a seeded
                synthetic SD-1.5 state dict (1.07 B parameters) written as
                fp16 .safetensors by the port's writer, loaded by
                StableDiffusion.from_checkpoint and by
                load_sd_checkpoint_streamed (each timed, with its peak host
                memory; every parameter equal to the file's value cast to
                bf16); a .ckpt VAE of another seed through with_vae and the
                restricted unpickler, and a request with the VAE on K3; then
                512² dpm++ Karras 20-step requests on conv_backend "kernel":
                the base; with_lora of a kohya file over every UNet and
                text-encoder conv/linear target (rank 8, alpha 4; every
                merged element within one bf16 ulp of a CPU fp32 merge) and
                at scale 0 (bit-identical to the base); an A1111 .pt
                textual inversion (2 vectors: ids >= 49408, a different
                image); an A1111 .pt hypernetwork (768, 1-2-1, one net with
                a LayerNorm) at strength 0.7 under the 4-window prompt, K2
                at all 16 cross-attentions an evaluation on k and v from
                separate allocations, and at strength 0 (bit-identical to
                the model without it); merged_with(alpha 0.3) equal to the
                fp32 formula cast to bf16; generate_many of 6 prompts at
                batch 4 (chunk 0 bit-identical to generate_images, chunk 1
                different, at most one host sync, the final copy, under
                torch's sync debug mode); a diffusers tree and a
                save_safetensors round trip, bit-identical.
                Slice C2 (``phase_slice_c2``, lines ``C2 ...``), run after
                phase 7 with the SD-1.5 models freed: BF16, full width,
                attention, conv and VAE on the kernels, batch 1: (a) SDXL
                base 1024², dpm++ Karras 10 steps, CFG 5, and (a') again,
                bit-identical; (b) with the 4-window prompt (K2 at all 70
                cross-attention layers an evaluation); (c) with
                original_size=(2048, 2048), crop_coords=(64, 64); (d) the
                refiner at 1024² over (a)'s latents through init_latents,
                strength 0.3; (e) SD-2.1 768-v at 768², euler_a 10 steps on
                the trailing grid; (f) generate_many of 3 SDXL prompts at
                batch 2 (at most one host sync); then files: a full-width
                SDXL fp16 .safetensors in the sgm key schema ((C, C)
                proj_in/proj_out, bigG's logit_scale, CLIP-L's
                position_ids) loaded eagerly and streamed, each tensor equal
                to the file's; 8-step requests on that bundle, with a kohya
                LoRA over CLIP-L, bigG and the UNet (lora_te1_, lora_te2_,
                lora_unet_; scale 0 bit-identical) and a dual-tower
                embedding's trigger.  Each request's launches are held to
                the plan (C2_PER_EVAL: K1 70/44/15 and K5 34/44/44 an
                evaluation for SDXL, the refiner and SD-2.1; K2 70 under the
                long prompt); one SDXL 1024² evaluation is profiled as in
                phase 7, with a 77- and a 308-token context.
                Slice C3 (``phase_slice_c3`` after slice D, lines ``C3
                ...``): BF16, full width, attention, conv and VAE on the
                kernels, seed 1337, the inpaint, InstructPix2Pix and LCM
                UNets phase 5's with conv_in or cond_proj drawn
                (``c3_variant``): (a) 9-channel inpainting at 512², dpm++
                Karras 10 steps, the right half masked, strength 1.0, and
                (a') again, bit-identical; (b) latent-blend inpainting on
                the 4-channel model at strength 0.75, mask_blur 4, on
                euler_a and heun: the final latents equal the init image's
                encoded latents wherever the latent mask is 0; (c)
                inpaint(full_res=True) of a 96x96 mask in a 768x512 image:
                every pixel outside the crop equal to the input's; (d)
                masked_content="fill"; (e) outpaint 64 px left and right
                (a 640x512 canvas); (f) img2img with color_correction; (g)
                edit, euler_a 10 steps, CFG 7.5, image guidance 1.5, also
                with the 4-window prompt (K2 at three lanes); (h) LCM 4
                steps without CFG; (i) hires_fix 512² -> 1024² at strength
                0.6, bilinear and lanczos3.  After slice C2, on SDXL
                (``phase_slice_c3_xl``): (j) 9-channel inpainting at 1024²,
                10 steps; (k) LCM 1024², 4 steps, without CFG.  Each
                request's launches are held to the plan of its generate()
                calls (``c3_run``: VAE encodes, two passes for hires_fix);
                its wall time and peak memory printed; one InstructPix2Pix
                (batch 3) and one LCM (batch 1) evaluation at 512², and one
                SDXL LCM evaluation at 1024², profiled as in phase 7.
                Slice E (``phase_slice_e`` after slice C3, lines ``E
                ...``): BF16, full width, kernel attention, conv and VAE,
                SD-1.5 512², dpm++ Karras 10 steps, CFG 7.5, the phase-5
                models with side nets drawn from a seed (``side_nets``):
                (a0) no side net; (a) a ControlNet on a Canny hint
                (``utils/annotators.canny`` of a seeded image), (a') again,
                bit-identical, (a'') at controlnet_scale 0, bit-identical
                to (a0); (b) two ControlNets at [1.0, 0.5]; (c) the
                T2I-Adapter; (d) IP-Adapter with ViT-H/14 (4 tokens) and
                (d') plus (the Resampler, 16 tokens); (e) reference-only in
                each mode at fidelity 0.5 and (e') attn at 768², 4 steps
                (K4 in the read); (f) a ControlNet with an IP-Adapter.
                After slice C3's SDXL requests (``phase_slice_e_xl``): (g)
                an SDXL ControlNet, (h) full_adapter_xl, (i) reference attn
                at 1024², 10 steps.  Each request's launches are held to
                the plan (``expected_launches(controlnets=, reference=)``:
                each ControlNet's encoder and mid an evaluation, the
                capture pass, the read's K2/K4 calls and the reference
                encode); one ControlNet and one reference evaluation at
                512² and at SDXL 1024² profiled as in phase 7.
                Slice F (``phase_slice_f`` after slice E, lines ``F
                ...``): the phase-5 models, BF16, kernel attention, conv
                and VAE, 512², dpm++ Karras 10 steps, CFG 7.5: each mode of
                ``phase_slice_f``'s docstring, with the bit-identities of
                variation strength 1 (seed 2's noise), the multiplier 1.0,
                DeepCache 1, Hypertile 64, FreeU (1, 1, 1, 1) and ToMe
                twice, and tiling's wrapping seams; one PAG, one DeepCache
                shallow and one Hypertile evaluation profiled; after phase
                7 (``phase_slice_f_big``) the fast preset at 2048², 4 steps
                (K4 0 launches) and Hypertile 32 at 2560², 2 steps (the
                guard refuses it without Hypertile); after slice E's SDXL
                requests (``phase_slice_f_xl``) SDXL 1024² with PAG, FreeU
                and Hypertile 32.  Each request's launches are held to the
                plan (``expected_launches(pag=, sag=, shallow=, tiling=)``).
                Slice G (``phase_slice_g`` after slice F, lines ``G
                ...``): the phase-5 models, BF16, kernel attention, conv
                and VAE, dpm++ Karras 10 steps, CFG 7.5, seed 1337: (a)
                ``with_motion`` on an fp16 .safetensors in the
                ``mm_sd_v15_v2`` key schema (21 modules, 453 M parameters,
                a 32-frame window; every loaded tensor the file's),
                ``animate`` 16 frames at 512² and (a') again,
                bit-identical; (b) 24 frames with ``motion_window=16``; (c)
                a 512x2048 panorama (7 windows) and a one-window 512²
                panorama bit-identical to ``generate``; (d) a 2048x4096
                panorama, 2 steps, 105 windows, its decode's mid block on
                K3 over 131072 tokens (``decode_tile=64``); (e)
                ``with_upscaler`` on a RealESRGAN_x4plus-width file in the
                new-arch key schema, ``upscale`` 512² -> 2048² whole and
                tiled; (f) ``hires_fix`` 512² -> 1024² through the ESRGAN;
                (g) ``sd_upscale`` x2 (9 tiles).  Each request's launches
                are held to the plan (``expected_launches(canvas=)``: each
                frame or panorama window a UNet call, the VAE at the
                canvas); one 32-lane AnimateDiff evaluation profiled with
                and without the motion modules, and one panorama window.
  7. step     — one 2048² VAE decode timed, with K3's device time in it;
                one 2048² CFG UNet evaluation timed, and profiled for the
                device busy share, on conv_backend "plain" and "kernel"; one
                512² CFG UNet evaluation with a 77- and a 308-token context,
                and one of CFG batch 8 (four prompts); each with the device
                time of K2, K5 and of the K1/K4 template by head dim.
  9. slice H2 — after the SDXL phases, SD-1.5 512² full width again (BF16,
                kernel attention, conv_backend "kernel", seed 0), lines
                ``H2 ...``: (a) a 20-step dpm++ Karras CFG 7.5 request
                under each int8 tier, "none", "wide", "conv" and "w8",
                through generate(): launches held to the plan (K1 equal
                across the tiers, K5 none under a tier), each tier's image
                PSNR against "none", and one evaluation of each profiled
                (device time, ``aten::_int_mm``'s share, busy share, peak
                memory); (b) ``int8_linear`` at (2, 256, 1280)·(1280,
                1280) and (1, 9, 1280)·(1280, 1280) (M padded) and
                ``int8_conv`` 3x3 at (2, 16², 1280 -> 1280) on the card and
                on the CPU from the same seeded inputs: equal int8 values,
                scales and int32 sums, outputs within fp32 rounding, and
                ``_int_mm`` timed beside the bf16 product / cuDNN conv;
                (c) ``python -m pytorch_stable_diffusion_tpu_torch --bf16
                --steps 4`` in a subprocess on a full-width bf16 file the
                port writes (``weights/save.py``) and tokenizer files the
                phase writes: its PNG equals StableDiffusion.txt2img's
                image, with the A1111 infotext; (d) a one-rank NCCL process
                group on a loopback TCP store: ``generate_images_dp`` and
                ``generate_images_tp`` over its 1x1 mesh equal the single
                card's images bit for bit; (e) ``device_trace`` around a
                2-step request writes a Chrome trace naming K1's kernel.
 10. slice H3a — sequence parallelism (``phase_slice_h3a``, lines ``H3a
                ...``), two gloo ranks spawned on the one card (each
                computes on cuda:0, the collectives go through the host:
                the exchanges are checked, not SP's latency), SD-1.5 full
                width, kernel attention, seed-0 weights built alike on
                every rank, ``parallel/sp.generate_spatial`` over a (1, 2)
                mesh: (a) 512² BF16, 8 dpm++ Karras steps, CFG 7.5, within
                35 dB of the same request on one process (K2 on each rank's
                q rows over the gathered K/V replaces K1); (b) 2048² BF16 at
                2 steps (K4, K3 and K2 on the local rows); (c) 256² FP32, 8
                steps, within one uint8 level of one process.  Each rank
                returns the whole image; its launches are held to the plan
                (``expected_launches(sp=2)``: 15 K2 an evaluation at 512²;
                K4 5, K3 5, K2 6 at 2048²; no K1, no K5).  Phase 3 holds K2,
                K3 and K4 at those shapes (``SP_PLANS``, ``sp_shapes``: q a
                view of the rank's fused projection, k and v the halves of
                the gathered (B, S, 2C) tensor), timed beside SDPA and the
                bound.
 11. slice H3b — the exported program (``phase_slice_h3b``, lines ``H3b
                ...``, run after slice H2's phase, before H3a's): SD-1.5
                BF16 at full width, seed-0 weights, attention, res blocks
                and VAE on the kernels (K1, K5 and K3 inside the
                artifact): ``utils/aot.export_pipeline`` of txt2img (512²,
                batch 1, 50 DDPM steps, CFG) and of img2img, each under 64
                MiB (the blob holds no weight; export launches no kernel),
                saved to a temporary directory, loaded and primed; seed
                1337 bit-identical to eager ``generate()`` (image and
                latents) with the plan's launches during the call, twice;
                img2img at strengths 0.8 and 0.5 from the one artifact,
                each bit-identical to eager with the plan's K3; a second
                model (seed 1) through the txt2img artifact, equal to eager
                with it and not to the first model's image; then each of
                the five custom ops called once through ``torch.ops.
                sdt_torch`` at a phase-3 shape against its plain version
                (K2 and K4 are not on the 512² artifact's path).  It
                prints the export, save, load and prime seconds, the
                artifact's first and second call against eager's wall;
                phase 3's host-cost line holds a K1 call through the op
                against the direct ctypes path under it.
 12. slice I — the rest of the JAX package's public surface
                (``phase_slice_i``, lines ``I ...``, right after H3b, on its
                artifact and slice D's checkpoint file): SD-1.5 512² at full
                width, attention, res blocks and VAE on the kernels (K1, K5,
                K3, launches held to the plan): (a) the JAX quick start with
                the port's names (``CLIPTokenizer.from_files``, top-level
                ``load_models`` of slice D's file, ``generate``, 20 DDPM
                steps) bit-identical to ``StableDiffusion.from_checkpoint``
                on the same file and seed; (b) ``MIXED`` (fp32 weights, the
                BF16 ones' values) against that BF16 request, bit-identical
                image and latents, or, naming the first module whose output
                differs, image PSNR >= 50 dB; the weights' bytes, peak
                device memory and one UNet evaluation's device time
                (torch.profiler) under each policy; (c) the serving loop,
                ``examples/torch_aot_serve.serve_request`` on H3b's txt2img
                artifact, three prompts at seeds 0, 1 and 2, each
                bit-identical to eager ``generate`` with its seed, each
                request's wall beside eager's.
Each phase prints its seconds on a line of its own (``phase ...``).  Then
one JSON line on the kernels, and last the contract line {"ok": true,
"device": {...}}.

Imports only torch, numpy and the port (no jax).  Kernels are built into
build/kernels/ of the checkout.
"""

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
import warnings

import torch

SD15_COUNTS = {"diffusion": 859_520_964, "clip": 123_060_480,
               "encoder": 34_163_664, "decoder": 49_490_199}
SDXL_COUNTS = {"clip": 123_060_480, "clip2": 694_659_840, "encoder": 34_163_664,
               "decoder": 49_490_199, "diffusion": 2_567_463_684}
CSRC = "pytorch_stable_diffusion_tpu_torch/csrc/"
PALLAS = "pytorch_stable_diffusion_tpu/ops/pallas/flash_attention.py"
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "flash_attention_bsc": (CSRC + "flash_attention_bsc.cu", PALLAS + ":384"),
    "flash_attention_onepass": (CSRC + "flash_attention_onepass.cu", PALLAS + ":587"),
    "flash_attention_streamed": (CSRC + "flash_attention_streamed.cu", PALLAS + ":466"),
    "flash_attention_multipass": (CSRC + "flash_attention_multipass.cu", PALLAS + ":507"),
    "scaled_silu_conv3x3": (CSRC + "scaled_silu_conv3x3.cu",
                            "pytorch_stable_diffusion_tpu/ops/pallas/conv.py:218"),
}
SHORT = {"flash_attention_bsc": "K1", "flash_attention_onepass": "K2",
         "flash_attention_streamed": "K4",
         "flash_attention_multipass": "K3", "scaled_silu_conv3x3": "K5"}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: KV length from which the JAX package always runs flash
#: (pytorch_stable_diffusion_tpu/ops/attention.py:221), K4 or K3 in the port
FLASH_ONLY_KV = 40960
#: launches of one 2048² CFG UNet evaluation (PERF.md): level 1 (65536
#: tokens) on K4 in 2 down and 3 up blocks; levels 2 and 3 and the mid block
#: on K1
PER_STEP_2048 = {"K1": 11, "K4": 5}
#: K5 launches of one UNet evaluation on conv_backend "kernel"/"kernel_fold"
#: (PERF.md): both halves of its 22 res blocks
K5_PER_EVAL = 44
#: K2 launches of one UNet evaluation under a context of 256+ tokens
#: (PERF.md): every one of its 16 cross-attentions
K2_PER_EVAL = 16
#: launches of one UNet evaluation of the slice-C2 families at their native
#: sizes (PERF.md §6), by family and kernel: K1 at every self-attention layer
#: (SDXL 1024²: 10 at level 1, 60 at level 2 and the mid block; the refiner:
#: 20, 20 and 4 at its 256-token mid block; SD-2.1 768²: 5 a level, its
#: 144-token mid block materialized), K2 at every cross-attention layer under
#: a 256+-token context, K5 at both halves of every res block on "kernel"
C2_PER_EVAL = {"sdxl": {"K1": 70, "K2": 70, "K5": 34},
               "refiner": {"K1": 44, "K2": 44, "K5": 44},
               "sd21": {"K1": 15, "K2": 15, "K5": 44}}
#: slice C2's K1 shapes at CFG batch 2, all Dh 64: (tokens, channels, heads)
#: of SDXL 1024² levels 1 and 2, the refiner's levels 1 and 2 and mid
#: block, SD-2.1 768² levels 1-3
K1_C2 = ((4096, 640, 10), (1024, 1280, 20), (4096, 768, 12), (1024, 1536, 24),
         (256, 1536, 24), (9216, 320, 5), (2304, 640, 10), (576, 1280, 20))
#: slice C2's K2 shapes under a 4-window prompt (KV 308), Dh 64: (q tokens,
#: heads) of SDXL's and the refiner's levels 1 and 2 and SD-2.1's level 1
K2_C2 = ((4096, 10), (1024, 20), (4096, 12), (1024, 24), (9216, 5))
#: H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, fp32 on the
#: CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
#: the SMs and maximum SM clock of the card (set in main): the exp floor of
#: the attention kernels, at 16 exp2 a clock on each SM (the SFU's rate)
SFU = {"sms": 0, "clock_hz": 0.0}
PROMPTS = ["a photograph of an astronaut riding a horse",
           "a watercolor painting of a lighthouse at dusk",
           "a close up photo of a red fox in the snow",
           "an isometric drawing of a small city"]
#: four 77-token windows (BREAK between them, which turns long prompts on),
#: with emphasis: a 308-token context
LONG_PROMPT = " BREAK ".join(["a (photograph:1.2) of an astronaut riding a horse",
                              *PROMPTS[1:3], "an isometric [drawing] of a small city"])
#: the same with a prompt edit at step 25 of 50
LONG_EDIT = LONG_PROMPT.replace("riding a horse", "riding a [horse:fox:10]")


#: the phase clock of main(): the start of the run and of the current phase
LAP = {"start": 0.0, "phase": 0.0}


def lap(name):
    """Print the seconds of the phase that ends here, on a line of its own."""
    now = time.perf_counter()
    print(f"phase {name}: {now - LAP['phase']:.1f} s ({now - LAP['start']:.1f} s in all)",
          flush=True)
    LAP["phase"] = now


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=None):
    """Mean ms of ``fn`` over ``iters`` launches (CUDA events) after one
    warm-up; by default as many launches as fill about a second."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if iters is None:
        iters = max(1, min(20, int(1.0 / max(time.perf_counter() - t0, 1e-4))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, dtype):
    """The least time the card could take: operations over the peak rate of
    their type, or bytes (each input read once, the output written once)
    over the memory rate, whichever is larger."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_ms(q, k, v, timer=cuda_ms):
    """The time of torch's own fused attention on the same (B, H, S, Dh)
    inputs, restricted to its flash and memory-efficient backends; None with
    the reason where neither takes the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fn = torch.nn.functional.scaled_dot_product_attention
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return timer(lambda: fn(q, k, v)), ""
    except RuntimeError as e:  # no fused backend takes this shape
        return None, str(e).splitlines()[0][:160]


def psnr(a, b):
    import numpy as np

    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    mse = np.mean((a - b) ** 2)
    return 10.0 * np.log10(max(np.abs(a).max(), 1e-12) ** 2 / max(mse, 1e-30))


def fused_views(b, sq, sk, heads, dh, dtype, g):
    """q, k, v as (B, H, S, Dh) views of one fused (B, Sk, 3C) projection,
    as the UNet makes them; with sq < sk, q is its first sq rows."""
    c = heads * dh
    qkv = torch.randn(b, sk, 3 * c, device="cuda", generator=g).to(dtype)
    q, k, v = qkv.split(c, dim=-1)
    q = q[:, :sq]
    return [t.reshape(b, t.shape[1], heads, dh).transpose(1, 2) for t in (q, k, v)]


def max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def tolerance(dtype, ref):
    """TOL[dtype], scaled down to the reference's largest value where that is
    below 1: at 65536 KV tokens the outputs are ~1e-2, and an absolute 2e-2
    would pass a kernel that returned zeros."""
    return TOL[dtype] * min(1.0, ref.float().abs().max().item())


# ------------------------------------------------------------------ kernels
def short_name(mangled):
    """A kernel's name and integer template arguments from its mangled name:
    the length-prefixed identifier in it that ends in ``kernel`` (else the
    longest), and each ``Li<n>E``."""
    names = [m.group(2)[:int(m.group(1))]
             for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled)
             if len(m.group(2)) >= int(m.group(1))]
    kernels = [n for n in names if n.endswith("kernel")]
    args = re.findall(r"Li(\d+)E", mangled)
    return (kernels or sorted(names, key=len)[-1:] or [mangled[:40]])[0] \
        + (f"<{', '.join(args)}>" if args else "")


def exp_floor_ms(exps):
    """The least time the SFU needs for ``exps`` exp2 evaluations: 16 a clock
    on each SM at the card's maximum SM clock."""
    return exps / (16.0 * SFU["sms"] * SFU["clock_hz"]) * 1e3


def phase_k1(fa, card, results):
    """K1 vs its plain version at SD-1.5's 512² shapes and at the shapes the
    2048² UNet gives it (levels 2 and 3 and the mid block; the 16384-token
    level checked on a subset of q rows, whose plain scores would take
    17 GB), ragged cases (Sq not a multiple of the q tile, Sk not one of
    the KV tile; Dh 40 with 8 packed heads, so a pad column read from the
    next head would show), Dh 64 (level 1 at 5 heads, timed beside SDPA,
    and ragged), in bf16 (the tensor-core template) and fp32; the later
    slices' shapes from the plan (C3's, F's and G's: AnimateDiff's 32
    lanes); the planted fault (KV short by one 128-token tile); device
    times under the profiler beside SDPA's, the bound and the exp floor."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(b, s, s, c, 8, s) for b in (2, 8)
             for s, c in ((4096, 320), (1024, 640), (256, 1280))]
    cases += [(2, 300, 300, 32, 1, 300), (2, 1000, 1100, 320, 8, 1000),
              (1, 333, 200, 640, 8, 333), (1, 130, 70, 1280, 8, 130)]
    cases += [(2, 16384, 16384, 640, 8, 2048), (2, 4096, 4096, 1280, 8, 4096),
              (2, 1024, 1024, 1280, 8, 1024)]
    # Dh 64: SD-1.5's level 1 at 5 heads (SD-2.x/SDXL's head dim), and ragged
    cases += [(2, 4096, 4096, 320, 5, 4096), (1, 300, 333, 128, 2, 300)]
    # slice C2, all at Dh 64: SDXL 1024² (levels 1 and 2), the refiner's
    # (levels 1 and 2, its mid block), SD-2.1 768² (levels 1-3)
    cases += [(2, s, s, c, h, min(s, 2048)) for s, c, h in K1_C2]
    cases += [(4, s, s, c, h, 1024) for s, c, h in K1_C2[:2]]  # SDXL generate_many, batch 2
    # slice C3's lane counts and shapes, from the UNet's plan (C3_PLANS)
    c3 = c3_shapes("K1")
    cases += [(b, s, s, c, h, min(s, 2048)) for b, s, c, h in c3
              if (b, s, s, c, h, min(s, 2048)) not in cases]
    # slice F's Hypertile tiles and ToMe's merged tokens, from the plan
    # (F_PLANS); correctness on fewer q rows where the batch is large
    f = f_shapes("K1")
    cases += [(b, s, s, c, h, min(s, 2048 if b <= 8 else 256)) for b, s, c, h in f
              if (b, s, s, c, h, min(s, 2048)) not in cases]
    # slice G: AnimateDiff's 32 lanes (G_PLANS), on 256 q rows
    g_k1 = g_shapes("K1")
    cases += [(b, s, s, c, h, min(s, 256)) for b, s, c, h in g_k1
              if (b, s, s, c, h, min(s, 256)) not in cases]
    timed = {(b, s, s, c, 8) for b in (2, 8)
             for s, c in ((4096, 320), (1024, 640), (256, 1280))}
    timed |= {(2, 16384, 16384, 640, 8), (2, 4096, 4096, 1280, 8), (2, 4096, 4096, 320, 5)}
    timed |= {(2, s, s, c, h) for s, c, h in K1_C2}
    timed |= {(b, s, s, c, h) for b, s, c, h in c3}
    timed |= {(b, s, s, c, h) for b, s, c, h in f}
    timed |= {(b, s, s, c, h) for b, s, c, h in g_k1}
    rec = results["flash_attention_bsc"]
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, sk, c, heads, rows in cases:
            qkv = torch.randn(b, max(sq, sk), 3 * c, device="cuda", generator=g).to(dtype)
            q, k, v = qkv.split(c, dim=-1)
            q, k, v = q[:, :sq], k[:, :sk], v[:, :sk]
            got = fa.flash_attention_bsc(q, k, v, n_heads=heads)
            torch.cuda.synchronize()
            ref = fa.flash_attention_bsc_plain(q[:, :rows], k, v, heads)
            err = max_err(got[:, :rows], ref)
            tol = tolerance(dtype, ref)
            check(got.shape == (b, sq, c) and got.dtype == dtype, "K1 output shape/dtype")
            check(err <= tol, f"K1 {dtype} {(b, sq, sk, c, heads)}: max abs err "
                              f"{err:.3e} > {tol:.3e}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            line = (f"K1 {str(dtype)[6:]} B={b} Sq={sq} Sk={sk} C={c} H={heads} "
                    f"Dh={c // heads}: max abs err {err:.3e} on {rows} q rows (tol {tol:.3e})")
            main = dtype == torch.bfloat16 and (b, sq, c, heads) == (2, 4096, 320, 8)
            if main or dtype == torch.bfloat16 and (b, sq, c, heads) in ((2, 4096, 640, 10),
                                                                        (32, 4096, 320, 8)):
                # KV short by one 128-token tile must fail the check (SD-1.5's
                # level 1, SDXL's at Dh 64, AnimateDiff's 32 lanes)
                bad = fa.flash_attention_bsc(q[:, :rows], k[:, :-128], v[:, :-128],
                                             n_heads=heads)
                bad_err = max_err(bad, ref)
                check(bad_err > tol, f"K1: a call missing 128 KV tokens passed the check "
                                     f"(max abs err {bad_err:.3e} <= {tol:.3e})")
                line += (f"; planted fault (KV short by 128 tokens) caught: max abs err "
                         f"{bad_err:.3e}")
            if (b, sq, sk, c, heads) in timed:
                flops = 4.0 * sq * sk * c * b
                exps = b * heads * sq * sk
                n0 = FALLBACKS[0]
                ms = one_call_device_ms(lambda: fa.flash_attention_bsc(q, k, v, n_heads=heads))
                line += (f"; kernel {ms:.4f} ms device ({flops / (ms * 1e-3) / 1e12:.1f} "
                         f"TFLOP/s)")
                if dtype == torch.bfloat16:
                    split = [t.reshape(b, t.shape[1], heads, c // heads).transpose(1, 2)
                             for t in (q, k, v)]
                    lib, why = sdpa_ms(*split, timer=one_call_device_ms)
                    bms, by = bound_ms(flops, 2 * b * (sq + sk) * c * 2, dtype)
                    line += (f", sdpa {'none' if lib is None else f'{lib:.4f}'} ms device"
                             f"{' ' + why if why else ''}; bound {bms:.4f} ms by {by}, exp "
                             f"floor {exp_floor_ms(exps):.4f} ms ({exps / 1e6:.0f} M exp2)")
                    if (sq, c, heads) in K1_C2 and b == 2:
                        rec["c2_shapes"].append(dict(shape=[b, sq, c], heads=heads, ms=ms,
                                                     library_ms=lib, bound_ms=bms,
                                                     bound_by=by))
                    if (b, sq, c, heads) in c3:
                        n, label = c3[(b, sq, c, heads)]
                        rec["c3_shapes"].append(dict(shape=[b, sq, c], heads=heads, ms=ms,
                                                     library_ms=lib, bound_ms=bms,
                                                     bound_by=by, per_eval=n,
                                                     request=label))
                    if (b, sq, c, heads) in f:
                        n, label = f[(b, sq, c, heads)]
                        rec["f_shapes"].append(dict(shape=[b, sq, c], heads=heads, ms=ms,
                                                    library_ms=lib, bound_ms=bms,
                                                    bound_by=by, per_eval=n, request=label))
                    if (b, sq, c, heads) in g_k1:
                        n, label = g_k1[(b, sq, c, heads)]
                        rec["g_shapes"].append(dict(shape=[b, sq, c], heads=heads, ms=ms,
                                                    library_ms=lib, bound_ms=bms,
                                                    bound_by=by, per_eval=n, request=label))
                    if main:
                        pms = one_call_device_ms(
                            lambda: fa.flash_attention_bsc_plain(q, k, v, heads))
                        rec.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=bms,
                                   bound_by=by, timer=timer_since(n0))
                        line += f"; plain {pms:.4f} ms device"
                line += f"  [{card}]"
            print(line, flush=True)
            del qkv, q, k, v, got, ref
    torch.cuda.empty_cache()


def host_cost(fa, card):
    """Host time of one small K1 call (2, 256, 1280) under inference mode,
    by CUDA events around 50 back-to-back calls (the kernel is shorter than
    its launch): the wrapper as it is, through the op ``torch.ops.sdt_torch.
    flash_attention_bsc`` (the dispatcher picks the op's CUDA
    implementation); the direct ctypes path under it (the wrapper's checks,
    then the CUDA implementation called as a function); and the wrapper with the C
    function's argument types bound again before every launch, as the
    wrappers did before they were bound once; alternated, twice each.  The
    op's cost over the direct path is also given for a 512² evaluation on
    the kernel backends (its K1 and K5 calls)."""
    import ctypes

    qkv = torch.randn(2, 256, 3 * 1280, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(1280, dim=-1)

    def rebinding():
        _, fn = fa._entry("flash_attention_bsc")
        fn.argtypes = list(fa._ARGTYPES["flash_attention_bsc"])
        fn.restype = ctypes.c_int
        return fa.flash_attention_bsc(q, k, v, n_heads=8)

    def through_op():
        return fa.flash_attention_bsc(q, k, v, n_heads=8)

    def direct():  # the wrapper as it was before the op: its checks, then ctypes
        fa._check(q, k, v, 8)
        return fa._launch(q, k, v, 8)

    arms = {"custom op": through_op, "direct ctypes": direct, "bound every call": rebinding}
    times = {name: [] for name in arms}
    with torch.inference_mode():  # as generate() and the artifact run them
        for _ in range(2):
            for name, fn in arms.items():
                times[name].append(cuda_ms(fn, 50) * 1e3)
    extra = min(times["custom op"]) - min(times["direct ctypes"])
    import pytorch_stable_diffusion_tpu_torch as port

    cfg = port.sd15_config(attention_backend="kernel", conv_backend="kernel",
                           vae_attention_backend="kernel")
    per_eval = expected_launches(cfg, 512, 512, steps=1, img2img=False)
    calls = per_eval["K1"] + per_eval["K5"]
    print("host: one K1 call (2, 256, 1280), CUDA events around 50 calls: "
          + "; ".join(f"{k} {', '.join(f'{t:.1f}' for t in v)} us" for k, v in times.items())
          + f"; the op adds {extra:.1f} us a call over the direct path, {extra * calls / 1e3:.3f}"
          f" ms a 512² evaluation ({calls} K1 and K5 calls)  [{card}]", flush=True)


def _check_rows(name, wrapper, plain, args, kw, rows, dtype, rec):
    """Launch ``wrapper`` at the full shape; hold its first ``rows`` q rows
    against the plain version run on those rows alone.  Returns the error,
    the tolerance and the reference."""
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    b, h, sq, dh = args[0].shape
    check(got.shape == (b, h, sq, dh) and got.dtype == dtype, f"{name} output shape/dtype")
    check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    rows = min(rows, sq)
    ref = plain(args[0][:, :, :rows], *args[1:], *kw.values())
    err = max_err(got[:, :, :rows], ref)
    tol = tolerance(dtype, ref)
    check(err <= tol, f"{name} {dtype} {tuple(args[0].shape)} kv {args[1].shape[2]}: "
                      f"max abs err {err:.3e} > {tol:.3e}")
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return err, tol, ref


def _planted_fault(name, wrapper, args, kw, rows, ref, tol, drop=4096):
    """The same check on a kernel call that drops the last ``drop`` KV tokens
    (a lost KV slab or tile): it must fail, or the check could not see such a
    fault."""
    short = args[1].shape[2] - drop
    bad = wrapper(args[0][:, :, :rows], args[1][:, :, :short], args[2][:, :, :short], **kw)
    err = max_err(bad, ref)
    check(err > tol, f"{name}: a call missing {drop} KV tokens passed the check "
                     f"(max abs err {err:.3e} <= {tol:.3e})")
    return f"; planted fault (KV short by {drop} tokens) caught: max abs err {err:.3e}"


def phase_long(fa, card, results):
    """K4 and K3 vs their plain versions at the 2048² shapes and edges.  K4
    runs every case in bf16 (the tensor-core template) and fp32; K3 its
    VAE shapes in both (slice G's too: ``G_K3``, 131072 tokens with the
    planted fault), causal cases (Dh 64, 128, 512) and head dims K4 lacks
    (80, 320), which it pads.  Times are device times under the
    profiler, with SDPA's, the bound and the exp floor beside them in bf16."""
    k3_launches(fa)
    g = torch.Generator(device="cuda").manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    k4 = [  # B, Sq, Sk, H, q rows checked, role
        (2, 65536, 65536, 8, 2048, "main"),
        (8, 65536, 65536, 8, 512, "time"),
        (2, 3000, 50001, 8, 3000, ""),
        (1, 999, 41000, 2, 999, ""),
        (1, 4096, 262144, 8, 1024, "time"),
    ]
    cases = [("K4", b, sq, sk, h, 40, dtype, False, rows, role if dtype == bf else "")
             for b, sq, sk, h, rows, role in k4 for dtype in (bf, f32)]
    cases += [  # kernel, B, Sq, Sk, H, Dh, dtype, causal, q rows checked, role
        ("K3", 1, 65536, 65536, 1, 512, bf, False, 4096, "main"),
        ("K3", 1, 65536, 65536, 1, 512, f32, False, 1024, "time"),
        ("K3", 1, 4096, 4096, 1, 512, bf, False, 4096, "time"),
        ("K3", 1, 4096, 4096, 1, 512, f32, False, 4096, "time"),
        ("K3", 1, 1000, 1000, 2, 512, bf, True, 1000, ""),
        ("K3", 1, 3001, 3001, 1, 64, f32, True, 3001, ""),
        # head dims K4 lacks, padded in the kernel (TMA zero-fills past Dh)
        ("K3", 1, 2000, 40960, 2, 80, bf, False, 2000, ""),
        ("K3", 1, 999, 40960, 2, 80, f32, False, 999, ""),
        ("K3", 1, 1500, 41000, 1, 320, bf, False, 1500, ""),
        ("K3", 1, 3001, 3001, 2, 128, bf, True, 3001, ""),
        # slice C2: the VAE mid block at 1024² (SDXL, the refiner) and 768²
        # (SD-2.1); K4 at Dh 64 (SD-2.1's level 1 from 40960 tokens)
        ("K3", 1, 16384, 16384, 1, 512, bf, False, 4096, "c2"),
        ("K3", 1, 16384, 16384, 1, 512, f32, False, 2048, ""),
        ("K3", 2, 16384, 16384, 1, 512, bf, False, 2048, ""),  # generate_many's decode
        ("K3", 1, 9216, 9216, 1, 512, bf, False, 4096, "c2"),
        ("K3", 1, 9216, 9216, 1, 512, f32, False, 2048, ""),
        ("K4", 1, 2048, 40960, 5, 64, bf, False, 2048, "c2"),
        ("K4", 1, 2048, 40960, 5, 64, f32, False, 1024, ""),
        # slice C3: the VAE mid block of outpaint's 640x512 canvas
        ("K3", 1, 5120, 5120, 1, 512, bf, False, 5120, "c3"),
        ("K3", 1, 5120, 5120, 1, 512, f32, False, 2048, ""),
    ]
    # slice G: the VAE mid blocks of its decodes (G_K3), the 2048x4096
    # panorama's 131072 tokens with the planted fault
    g_k3 = {(b, h, sq, sq, dh): (n, label) for b, h, sq, dh, n, label in G_K3}
    for b, h, sq, _, dh in g_k3:
        cases += [("K3", b, sq, sq, h, dh, bf, False, 2048 if sq > 65536 else 1024, "g"),
                  ("K3", b, sq, sq, h, dh, f32, False, 512, "")]
    # slice E: K4 with Sq != Sk, the 768² reference read (E_PLANS), q and k/v
    # from separate projections
    e = e_shapes("K4")
    for b, h, sq, sk, dh in e:
        cases += [("K4", b, sq, sk, h, dh, bf, False, 2048, "e"),
                  ("K4", b, sq, sk, h, dh, f32, False, 512, "")]
    # slice H3a: K4 and K3 on each rank's q rows over the gathered K/V at
    # 2048² (SP_PLANS)
    sp = {**sp_shapes("K4"), **sp_shapes("K3")}
    for b, h, sq, sk, dh in sp:
        kname = "K4" if dh in K4_DH else "K3"
        cases += [(kname, b, sq, sk, h, dh, bf, False, 2048, "sp"),
                  (kname, b, sq, sk, h, dh, f32, False, 512, "")]
    for kname, b, sq, sk, h, dh, dtype, causal, rows, role in cases:
        name = "flash_attention_streamed" if kname == "K4" else "flash_attention_multipass"
        wrapper = getattr(fa, name)
        plain = getattr(fa, f"{name}_plain")
        kw = {} if kname == "K4" else {"causal": causal}
        rec = results[name]
        views = separate_views if kname == "K4" and (b, h, sq, sk, dh) in e else \
            sp_views if (b, h, sq, sk, dh) in sp else fused_views
        args = views(b, sq, sk, h, dh, dtype, g)
        t0 = time.perf_counter()
        err, tol, ref = _check_rows(kname, wrapper, plain, args, kw, rows, dtype, rec)
        line = (f"{kname} {str(dtype)[6:]} B={b} H={h} Sq={sq} Sk={sk} Dh={dh}"
                f"{' causal' if causal else ''}: max abs err {err:.3e} on "
                f"{min(rows, sq)} q rows (tol {tol:.3e})")
        if role == "main" or role == "g" and sq > 65536:
            line += _planted_fault(kname, wrapper, args, kw, min(rows, sq), ref, tol)
        if role:
            flops = 4.0 * b * h * sq * sk * dh * (0.5 if causal else 1.0)
            nbytes = b * h * (2 * sq + 2 * sk) * dh * args[0].element_size()
            bms, by = bound_ms(flops, nbytes, dtype)
            # device time; in bf16 SDPA's beside it, the bound and the exp floor
            timer = device_ms if sq * sk >= 1 << 28 else one_call_device_ms
            n0 = FALLBACKS[0]
            ms = timer(lambda: wrapper(*args, **kw))
            line += (f"; kernel {ms:.4f} ms device ({flops / (ms * 1e-3) / 1e12:.1f} "
                     f"TFLOP/s)")
            lib = None
            if dtype == bf:
                lib, why = sdpa_ms(*args, timer=timer)
                line += (f", sdpa {'none' if lib is None else f'{lib:.4f}'} ms "
                         f"device{' ' + why if why else ''}; bound {bms:.4f} ms by {by}, "
                         f"exp floor {exp_floor_ms(b * h * sq * sk):.4f} ms")
            if role == "main":
                pms = cuda_ms(lambda: plain(*args, *kw.values()), 1)
                rec.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=bms, bound_by=by,
                           timer=timer_since(n0))
                line += f"; plain {pms:.3f} ms"
            if role in ("c2", "c3"):
                rec[f"{role}_shapes"].append(dict(shape=[b, h, sq, sk, dh], ms=ms,
                                                  library_ms=lib, bound_ms=bms, bound_by=by))
            if role in ("e", "sp"):
                n, label = (e if role == "e" else sp)[(b, h, sq, sk, dh)]
                rec[f"{role}_shapes"].append(dict(shape=[b, h, sq, sk, dh], ms=ms,
                                                  library_ms=lib, bound_ms=bms, bound_by=by,
                                                  per_eval=n, request=label))
            if role == "sp":
                pms = cuda_ms(lambda: plain(*args, *kw.values()), 1)
                rec["sp_shapes"][-1]["plain_ms"] = pms
                line += f"; plain {pms:.3f} ms"
            if role == "g":
                n, label = g_k3[(b, h, sq, sk, dh)]
                rec["g_shapes"].append(dict(shape=[b, h, sq, sk, dh], ms=ms, library_ms=lib,
                                            bound_ms=bms, bound_by=by, per_request=n,
                                            request=label))
        print(f"{line} ({time.perf_counter() - t0:.1f} s)  [{card}]", flush=True)
        del args, ref
        torch.cuda.empty_cache()


def k3_launches(fa):
    """K3's bf16 launch configuration at each padded width: ring stages (K or
    V tiles of 32 tokens), shared memory, CTAs an SM."""
    import ctypes

    lib, _ = fa._entry("flash_attention_multipass")
    conf = lib.sdt_flash_attention_multipass_config
    conf.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    conf.restype = ctypes.c_int
    parts = []
    for dh in (128, 256, 512):
        vals = [ctypes.c_int() for _ in range(3)]
        check(conf(dh, *map(ctypes.byref, vals)) == 0, "K3 config")
        stages, smem, ctas = (v.value for v in vals)
        parts.append(f"Dh<={dh}: {stages} stages, {smem} B, {ctas} CTA(s) an SM")
    print("K3 bf16 launch: 384 threads (a producer and two consumer warpgroups, 64 q rows), "
          "no cluster; " + "; ".join(parts), flush=True)


def cross_views(b, sq, sk, heads, dh, dtype, g):
    """q from its own (B, Sq, C) projection, k and v as the two halves of one
    fused (B, Sk, 2C) projection of the context, all viewed as (B, H, S,
    Dh), as the UNet's cross-attention makes them."""
    c = heads * dh
    q = torch.randn(b, sq, c, device="cuda", generator=g).to(dtype)
    kv = torch.randn(b, sk, 2 * c, device="cuda", generator=g).to(dtype)
    return [t.reshape(b, t.shape[1], heads, dh).transpose(1, 2)
            for t in (q, *kv.split(c, dim=-1))]


def sp_views(b, sq, sk, heads, dh, dtype, g):
    """q as a (B, H, Sq, Dh) view of a rank's fused (B, Sq, 3C) projection,
    k and v as the halves of the gathered (B, Sk, 2C) K/V: a self-attention
    under sequence parallelism."""
    c = heads * dh
    q = torch.randn(b, sq, 3 * c, device="cuda", generator=g).to(dtype)[..., :c]
    kv = torch.randn(b, sk, 2 * c, device="cuda", generator=g).to(dtype)
    return [t.reshape(b, t.shape[1], heads, dh).transpose(1, 2)
            for t in (q, *kv.split(c, dim=-1))]


def separate_views(b, sq, sk, heads, dh, dtype, g):
    """q, k and v each from its own contiguous (B, S, C) allocation, viewed as
    (B, H, S, Dh): k and v as a hypernetwork's cross-attention makes them,
    projected from contexts of their own."""
    c = heads * dh
    return [torch.randn(b, s, c, device="cuda", generator=g).to(dtype)
            .reshape(b, s, heads, dh).transpose(1, 2) for s in (sq, sk, sk)]


def k2_schedule_text(s):
    return (f"{s['warpgroups']} consumer warpgroup(s) ({64 * s['warpgroups']} q rows), "
            f"{s['ctas']} CTA(s) a head, {s['stages']} stages, {s['smem']} B")


def phase_k2(fa, card, results):
    """K2 vs its plain version at the cross-attentions of a 4-window prompt
    at 512² (levels 1-3 and the mid block, CFG batch 2 and 8; at batch 2
    also with k and v in two allocations of their own, as a hypernetwork's
    k/v contexts give them), a ragged KV,
    causal cases across 64-, 128- and 192-row CTAs and with several q tiles
    a CTA, causal with Sq < Sk, a KV of one tile and less, and the one-pass
    envelope's top (KV 9216), in bf16 and fp32, each with the schedule its
    bf16 launch takes; the planted fault (KV short by 64 tokens); at the
    four level shapes at CFG batch 2, and at levels 1 and 2 under a 5- and
    a 6-window prompt (385 and 462 tokens: past the three 128-token stages
    that keep a 308-token KV resident at Dh 80), the device time beside
    SDPA's, the bound and the exp floor."""
    g = torch.Generator(device="cuda").manual_seed(5)
    wrapper, plain = fa.flash_attention_onepass, fa.flash_attention_onepass_plain
    rec = results["flash_attention_onepass"]
    levels = ((4096, 40), (1024, 80), (256, 160), (64, 160))
    # B, H, Sq, Sk, Dh, causal, q rows checked, role
    cases = [(b, 8, sq, 308, dh, False, sq,
              "time" if b == 8 else "main" if sq == 4096 else "level")
             for b in (2, 8) for sq, dh in levels]
    cases += [(2, 8, sq, sk, dh, False, sq, "level")
              for sk in (385, 462) for sq, dh in levels[:2]]
    # k and v in two allocations of their own (a hypernetwork's k/v contexts)
    cases += [(2, 8, sq, 308, dh, False, sq, "separate") for sq, dh in levels]
    # slice C2 under a 4-window prompt, Dh 64: SDXL's and the refiner's levels
    # 1 and 2 at 1024², SD-2.1's level 1 at 768²
    cases += [(2, h, sq, 308, 64, False, min(sq, 2048), "c2") for sq, h in K2_C2]
    # slice C3: InstructPix2Pix's three lanes under a 4-window prompt (C3_PLANS)
    c3 = c3_shapes("K2")
    cases += [(b, h, sq, sk, dh, False, min(sq, 2048), "c3") for b, h, sq, sk, dh in c3]
    # slice E: the reference reads' [own, banked] attention (E_PLANS), q and
    # k/v from separate projections
    e = e_shapes("K2")
    cases += [(b, h, sq, sk, dh, False, min(sq, 2048), "e") for b, h, sq, sk, dh in e]
    # slice H3a: each rank's q rows over the gathered K/V (SP_PLANS)
    sp = sp_shapes("K2")
    cases += [(b, h, sq, sk, dh, False, min(sq, 2048), "sp") for b, h, sq, sk, dh in sp]
    cases += [(2, 8, 1000, 300, 40, False, 1000, ""),   # ragged q and KV
              (1, 2, 1024, 1024, 64, True, 1024, ""),   # causal across 64-row CTAs
              (4, 8, 2000, 2000, 40, True, 512, ""),    # causal across 128-row CTAs
              (1, 8, 2304, 2304, 40, True, 2304, ""),   # causal across 192-row CTAs
              (2, 8, 2000, 700, 40, True, 2000, ""),    # causal, 2 q tiles a CTA
              (2, 8, 700, 1100, 64, True, 700, ""),     # causal, Sq < Sk, ragged
              (2, 8, 4096, 77, 40, False, 4096, ""),    # a KV of less than one tile
              (1, 2, 130, 1, 80, False, 130, ""),       # one KV token
              (2, 8, 9216, 9216, 40, False, 2048, "")]  # the envelope's top
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, sq, sk, dh, causal, rows, role in cases:
            views = separate_views if role in ("separate", "e") else \
                sp_views if role == "sp" else cross_views
            args = views(b, sq, sk, h, dh, dtype, g)
            kw = {"causal": causal}
            err, tol, ref = _check_rows("K2", wrapper, plain, args, kw, rows, dtype, rec)
            line = (f"K2 {str(dtype)[6:]} B={b} H={h} Sq={sq} Sk={sk} Dh={dh}"
                    f"{' causal' if causal else ''}"
                    f"{', k and v in separate allocations' if role == 'separate' else ''}"
                    f": max abs err {err:.3e} on "
                    f"{min(rows, sq)} q rows (tol {tol:.3e})")
            if dtype == torch.bfloat16:
                line += f"; {k2_schedule_text(fa.onepass_schedule(b, h, sq, sk, dh, causal))}"
            if role == "main":
                line += _planted_fault("K2", wrapper, args, kw, rows, ref, tol, drop=64)
            if role in ("main", "level", "time", "c2", "c3", "e", "sp") \
                    and dtype == torch.bfloat16:
                # a call is shorter than its host launch cost, so CUDA events
                # around back-to-back calls time the host: the recorded times
                # are device times under the profiler
                flops = 4.0 * b * h * sq * sk * dh
                events = cuda_ms(lambda: wrapper(*args, **kw), 50)
                n0 = FALLBACKS[0]
                ms = one_call_device_ms(lambda: wrapper(*args, **kw))
                line += (f"; kernel {ms:.4f} ms device ({flops / (ms * 1e-3) / 1e12:.2f} "
                         f"TFLOP/s), {events:.4f} ms by events")
                if role in ("main", "level", "c2", "c3", "e", "sp"):
                    lib, why = sdpa_ms(*args, timer=one_call_device_ms)
                    nbytes = b * h * (2 * sq + 2 * sk) * dh * args[0].element_size()
                    bms, by = bound_ms(flops, nbytes, dtype)
                    line += (f"; sdpa {'none' if lib is None else f'{lib:.4f}'} ms device"
                             f"{' ' + why if why else ''}; bound {bms:.4f} ms by {by}, exp "
                             f"floor {exp_floor_ms(b * h * sq * sk):.4f} ms")
                if role == "c2":
                    rec["c2_shapes"].append(dict(shape=[b, h, sq, sk, dh], ms=ms,
                                                 library_ms=lib, bound_ms=bms, bound_by=by))
                if role in ("c3", "e", "sp"):
                    n, label = {"c3": c3, "e": e, "sp": sp}[role][(b, h, sq, sk, dh)]
                    rec[f"{role}_shapes"].append(dict(shape=[b, h, sq, sk, dh], ms=ms,
                                                      library_ms=lib, bound_ms=bms,
                                                      bound_by=by, per_eval=n, request=label))
                if role == "sp":
                    pms = one_call_device_ms(lambda: plain(*args, causal))
                    rec["sp_shapes"][-1]["plain_ms"] = pms
                    line += f"; plain {pms:.4f} ms device"
                if role == "main":
                    pms = one_call_device_ms(lambda: plain(*args, causal))
                    rec.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=bms, bound_by=by,
                               timer=timer_since(n0))
                    line += f"; plain {pms:.4f} ms device"
                line += f"  [{card}]"
            print(line, flush=True)
            del args, ref
    print(f"K2: {2 * len(cases)} cases within tolerance ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    torch.cuda.empty_cache()


def res_convs(cfg, height, width):
    """(H, W, Cin, Cout) of the 44 res-block 3x3 convs of one SD-1.5 UNet
    evaluation, in order, from the UNet's plan: both halves of every res
    block of the encoder, the bottleneck and the decoder."""
    from pytorch_stable_diffusion_tpu_torch.models import unet

    u = cfg.unet
    h = height // cfg.vae.downsample_factor
    w = width // cfg.vae.downsample_factor
    convs, level = [], 0

    def block(c_in, c_out):
        convs.extend([(h >> level, w >> level, c_in, c_out),
                      (h >> level, w >> level, c_out, c_out)])

    for st in unet.encoder_plan(u)[1:]:
        if st["kind"] == "down":
            level += 1
        else:
            block(st["c_in"], st["c_out"])
    block(u.level_channels[-1], u.level_channels[-1])  # the bottleneck's two
    block(u.level_channels[-1], u.level_channels[-1])
    for st in unet.decoder_plan(u):
        block(st["c_in"], st["c_out"])
        if st["upsample"]:
            level -= 1
    return convs


def conv_flops(b, h, w, cin, cout):
    return 2.0 * 9 * cin * cout * h * w * b


def k5_inputs(b, h, w, cin, cout, dtype, g):
    """x (channels_last), GroupNorm parameters, a channels_last weight
    ~ N(0, 1/(9 Cin)), a bias and a time embedding, on the card."""
    from pytorch_stable_diffusion_tpu_torch.ops import norm

    cl = torch.channels_last
    x = torch.randn(b, cin, h, w, device="cuda", generator=g).to(dtype).contiguous(
        memory_format=cl)
    gn = norm.Norm(cin, device="cuda")
    gn.weight.data = 1.0 + 0.2 * torch.randn(cin, device="cuda", generator=g)
    gn.bias.data = 0.5 * torch.randn(cin, device="cuda", generator=g)
    weight = (torch.randn(cout, cin, 3, 3, device="cuda", generator=g) / (9 * cin) ** 0.5) \
        .to(dtype).contiguous(memory_format=cl)
    bias = 0.1 * torch.randn(cout, device="cuda", generator=g)
    temb = torch.randn(b, cin, device="cuda", generator=g).to(dtype)
    return x, gn, weight, bias, temb


def k5_tolerance(dtype, ref):
    """TOL[dtype] times the reference's largest value: a conv's outputs reach
    several units, and bf16 rounds them relatively."""
    return TOL[dtype] * ref.float().abs().max().item()


def phase_k5(k5, card, results):
    """K5 against its plain version at every (batch, shape) at which this
    script's paths run it, read from the UNet's plan: the res-block convs of
    SD-1.5 512² at CFG batch 2 (with and without the time-embedding fold)
    and 8 (four prompts), of 2048² at batch 2 (phase 7) and of 128² at batch
    2 (phase 4), the later slices' (C2's widths, C3's and G's lane counts:
    AnimateDiff's 32 lanes) and a ragged case, in bf16 and fp32; the
    planted fault (at 32 lanes too); times at the largest 512² shape, at
    2048² level 1 and at 32 lanes, and summed over the 44 convs of a 512²
    CFG step."""
    import pytorch_stable_diffusion_tpu_torch as port

    g = torch.Generator(device="cuda").manual_seed(4)
    rec = results["scaled_silu_conv3x3"]
    cfg = port.sd15_config()

    def distinct(convs):
        return sorted(set(convs), key=lambda s: (-s[0], s[2], s[3]))

    step = res_convs(cfg, 512, 512)
    shapes = distinct(step)
    main = (2, 64, 64, 960, 320)  # the largest 512² conv (45 GFLOP, with 32² 1920 -> 640)
    cases = [(2, *s, temb) for s in shapes for temb in (False, True)]
    cases += [(8, *s, False) for s in shapes]
    cases += [(2, *s, False) for size in (2048, 128) for s in distinct(res_convs(cfg, size, size))]
    cases += [(2, 10, 12, 64, 128, True)]
    # slice C2: SDXL's and the refiner's res-block convs at 1024², SD-2.1's at
    # 768² (SD-1.5's widths), batch 2, with the time-embedding fold
    c2 = distinct([s for name, size in (("sdxl_config", 1024), ("sdxl_refiner_config", 1024),
                                        ("sd21_config", 768))
                   for s in res_convs(getattr(port, name)(), size, size)])
    cases += [(2, *s, True) for s in c2 if (2, *s, True) not in cases]
    # SDXL's generate_many at batch 2: CFG batch 4
    cases += [(4, *s, True) for s in distinct(res_convs(port.sdxl_config(), 1024, 1024))]
    c2_timed = {(2, 128, 128, 384, 384), (2, 128, 128, 960, 320), (2, 32, 32, 3072, 1536),
                (2, 96, 96, 320, 320)}
    # slice C3's lane counts and shapes (C3_PLANS); timed at each request's
    # conv of the most operations (of two, the one at the larger level)
    c3 = c3_shapes("K5")
    cases += [(*key, True) for key in c3 if (*key, True) not in cases]
    c3_timed = {max((key for key in c3 if c3[key][1] == label),
                    key=lambda k: (conv_flops(*k), k[1]))  # ties: the larger level
                for label in {v[1] for v in c3.values()}}
    # slice G: AnimateDiff's 32 lanes at every res-block conv (G_PLANS), the
    # planted fault and a time at the largest, 126 M input elements
    g_k5 = g_shapes("K5")
    cases += [(*key, True) for key in g_k5]
    g_main = (32, 64, 64, 960, 320)
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        worst = (0.0, None)
        for b, h, w, cin, cout, with_temb in cases:
            x, gn, weight, bias, temb = k5_inputs(b, h, w, cin, cout, dtype, g)
            scale, shift = k5.fold_gn_affine(gn, x, 32, temb=temb if with_temb else None)
            got = k5.scaled_silu_conv3x3(x, scale, shift, weight, bias)
            torch.cuda.synchronize()
            check(got.shape == (b, cout, h, w) and got.dtype == dtype
                  and got.is_contiguous(memory_format=torch.channels_last),
                  "K5 output shape/dtype/format")
            ref = k5.scaled_silu_conv3x3_plain(x, scale, shift, weight, bias)
            err, tol = max_err(got, ref), k5_tolerance(dtype, ref)
            check(err <= tol, f"K5 {dtype} {(b, h, w, cin, cout)} temb={with_temb}: max abs "
                              f"err {err:.3e} > {tol:.3e}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            worst = max(worst, (err / tol, (b, h, w, cin, cout, with_temb, err, tol)),
                        key=lambda e: e[0])
            if (b, h, w, cin, cout) == main and not with_temb or \
                    (b, h, w, cin, cout) == g_main and dtype == torch.bfloat16:
                a = torch.nn.functional.pad(x.float(), (1, 1, 1, 1))
                a = torch.nn.functional.silu(a * scale[:, :, None, None]
                                             + shift[:, :, None, None]).to(dtype)
                bad = torch.nn.functional.conv2d(a, weight, bias.to(dtype))
                bad_err = max_err(bad, ref)
                check(bad_err > tol, f"K5: padding before the activation passed the "
                                     f"check ({bad_err:.3e} <= {tol:.3e})")
                print(f"K5 {str(dtype)[6:]} {(b, h, w, cin, cout)}: max abs err {err:.3e} "
                      f"(tol {tol:.3e}); "
                      f"planted fault (padding before the activation) caught: max abs "
                      f"err {bad_err:.3e}", flush=True)
            key = (b, h, w, cin, cout)
            if dtype == torch.bfloat16 and (not with_temb and key in (
                    main, (2, 256, 256, 320, 320)) or key in c2_timed
                    or with_temb and key in c3_timed or key == g_main):
                flops = conv_flops(b, h, w, cin, cout)
                n0 = FALLBACKS[0]
                ms = one_call_device_ms(
                    lambda: k5.scaled_silu_conv3x3(x, scale, shift, weight, bias))
                pms = cuda_ms(lambda: k5.scaled_silu_conv3x3_plain(x, scale, shift,
                                                                   weight, bias))
                a = torch.nn.functional.silu(x.float() * scale[:, :, None, None]
                                             + shift[:, :, None, None]).to(dtype)
                bias_c = bias.to(dtype)
                lib = one_call_device_ms(
                    lambda: torch.nn.functional.conv2d(a, weight, bias_c, padding=1))
                tier = one_call_device_ms(lambda: plain_tier_conv(gn, x, weight, bias_c))
                fused = one_call_device_ms(lambda: k5.gn_silu_conv3x3(
                    gn, _Conv(weight, bias), x, 32))
                nbytes = (x.numel() + got.numel() + weight.numel()) * x.element_size() \
                    + 4 * (scale.numel() + shift.numel() + bias.numel())
                bms, by = bound_ms(flops, nbytes, dtype)
                if (b, h, w, cin, cout) == main:
                    rec.update(ms=ms, plain_ms=pms, library_ms=lib, bound_ms=bms, bound_by=by,
                               timer=timer_since(n0))
                if key in c2_timed:
                    rec["c2_shapes"].append(dict(shape=[b, h, w, cin, cout], ms=ms,
                                                 library_ms=lib, bound_ms=bms, bound_by=by))
                if key in c3_timed and with_temb:
                    n, label = c3[key]
                    rec["c3_shapes"].append(dict(shape=[b, h, w, cin, cout], ms=ms,
                                                 library_ms=lib, bound_ms=bms, bound_by=by,
                                                 per_eval=n, request=label))
                if key == g_main:
                    n, label = g_k5[key]
                    rec["g_shapes"].append(dict(shape=[b, h, w, cin, cout], ms=ms,
                                                library_ms=lib, bound_ms=bms, bound_by=by,
                                                per_eval=n, request=label))
                print(f"K5 bf16 {(b, h, w, cin, cout)}: kernel {ms:.4f} ms device "
                      f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain {pms:.3f} ms "
                      f"(events), cuDNN conv alone on the activated input {lib:.4f} ms "
                      f"device, the plain tier's GroupNorm + SiLU + cuDNN conv {tier:.4f} ms "
                      f"device, the kernel tier's folded GroupNorm + K5 {fused:.4f} ms "
                      f"device; bound {bms:.4f} ms by {by}  [{card}]", flush=True)
            del x, gn, weight, bias, temb, scale, shift, got, ref
        r, (b, h, w, cin, cout, with_temb, err, tol) = worst
        print(f"K5 {str(dtype)[6:]}: {len(cases)} cases within tolerance; closest "
              f"{(b, h, w, cin, cout)} temb={with_temb}: err {err:.3e} = {r:.2f} x tol",
              flush=True)
        torch.cuda.empty_cache()
    # the 44 convs of one 512² CFG step: device time under the profiler (the
    # launches are host-bound at the small levels, so CUDA events around
    # back-to-back calls would time the host); beside K5 alone, the kernel
    # tier's whole half (folded GroupNorm + K5), the plain tier's (GroupNorm
    # + SiLU + cuDNN conv), cuDNN's conv alone and K5's plain version
    calls = {"kernel": [], "kernel tier": [], "plain tier": [], "cudnn": [], "plain": []}
    flops = 0.0
    for h, w, cin, cout in shapes:
        x, gn, weight, bias, _ = k5_inputs(2, h, w, cin, cout, torch.bfloat16, g)
        scale, shift = k5.fold_gn_affine(gn, x, 32)
        a = torch.nn.functional.silu(x.float() * scale[:, :, None, None]
                                     + shift[:, :, None, None]).to(torch.bfloat16)
        bias_c = bias.to(torch.bfloat16)
        args = (x, scale, shift, weight, bias)
        n = step.count((h, w, cin, cout))
        calls["kernel"] += [(k5.scaled_silu_conv3x3, args)] * n
        calls["kernel tier"] += [(lambda gn, x, cv: k5.gn_silu_conv3x3(gn, cv, x, 32),
                                  (gn, x, _Conv(weight, bias)))] * n
        calls["plain tier"] += [(plain_tier_conv, (gn, x, weight, bias_c))] * n
        calls["cudnn"] += [(lambda a, w, b: torch.nn.functional.conv2d(a, w, b, padding=1),
                            (a, weight, bias_c))] * n
        calls["plain"] += [(k5.scaled_silu_conv3x3_plain, args)] * n
        flops += n * conv_flops(2, h, w, cin, cout)
    check(len(step) == K5_PER_EVAL, f"{len(step)} res-block convs a step, PERF.md states "
                                    f"{K5_PER_EVAL}")
    dev = {k: device_ms(lambda: [fn(*args) for fn, args in v], len(v))
           for k, v in calls.items()}
    print(f"K5 one 512² CFG step (44 convs, {flops / 1e9:.0f} GFLOP, bound "
          f"{flops / PEAK_FLOPS[torch.bfloat16] * 1e3:.3f} ms), device time: kernel "
          f"{dev['kernel']:.3f} ms ({flops / (dev['kernel'] * 1e-3) / 1e12:.1f} TFLOP/s), "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in dev.items() if k != "kernel")
          + f" ({time.perf_counter() - t0:.1f} s)  [{card}]", flush=True)
    del calls
    k5_launches(k5, card, cfg)
    torch.cuda.empty_cache()


class _Conv(torch.nn.Module):
    """A conv parameter holder for ``gn_silu_conv3x3`` (weight, bias)."""

    def __init__(self, weight, bias):
        super().__init__()
        self.weight, self.bias = weight, bias


def plain_tier_conv(gn, x, weight, bias):
    """What conv_backend="plain" runs for a res-block half in BF16: GroupNorm
    (fp32 statistics) -> SiLU -> cuDNN's conv (models/unet.py ResBlock)."""
    from pytorch_stable_diffusion_tpu_torch.core.dtypes import BF16
    from pytorch_stable_diffusion_tpu_torch.ops import norm

    h = norm.group_norm_silu(gn, x, 32, policy=BF16)
    return torch.nn.functional.conv2d(h, weight, bias, padding=1)


def k5_launches(k5, card, cfg):
    """K5's bf16 launch configuration (weight-ring stages, shared memory, CTAs
    an SM) and the Cin split it takes at each distinct 512² and 2048²
    res-block conv at batch 2."""
    import ctypes

    from pytorch_stable_diffusion_tpu_torch.ops.cuda import build

    lib, _ = build.load("scaled_silu_conv3x3")
    conf = lib.sdt_scaled_silu_conv3x3_config
    conf.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 4
    conf.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    splits = {}
    for size in (512, 2048):
        for h, w, cin, cout in sorted(set(res_convs(cfg, size, size)),
                                      key=lambda s: (-s[0], s[2], s[3])):
            check(conf(2, h, w, cin, cout, *map(ctypes.byref, vals)) == 0, "K5 config")
            splits[(h, w, cin, cout)] = vals[3].value
    stages, smem, ctas = (v.value for v in vals[:3])
    print(f"K5 bf16 launch: 384 threads (a producer and two consumer warpgroups), "
          f"{stages} weight stages, {smem} bytes of shared memory, {ctas} CTA(s) an SM; "
          f"Cin split (a cluster along z) at batch 2: "
          + ", ".join(f"{s}: {n}" for s, n in splits.items()) + f"  [{card}]", flush=True)


def one_call_device_ms(fn):
    """Device time of one call of ``fn``: ten calls under the profiler, over
    ten."""
    return device_ms(lambda: [fn() for _ in range(10)], 10) / 10


#: how many device_ms measurements so far were timed by CUDA events
FALLBACKS = [0]
#: the least time a call must take for CUDA events around it to stand for
#: its device time: 1 ms is a hundred times a launch's host cost
EVENTS_MIN_MS = 1.0


def timer_since(n0):
    """The timer of the measurements made since FALLBACKS was ``n0``."""
    return "profiler" if FALLBACKS[0] == n0 else "events"


def device_ms(fn, calls=1):
    """Device time of the CUDA kernels ``fn`` launches in its ``calls``
    calls, summed from one run under torch.profiler after a warm-up run.  A
    run in which the profiler recorded no kernel at all is made again, up to
    three times.  Then, where a call takes EVENTS_MIN_MS or more, the run is
    timed with CUDA events around it, which the script says on a line of its
    own and counts in FALLBACKS; a shorter call fails the run, because events
    around it would time the host's launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA") / 1e3
        if total > 0:
            return total
    ms = cuda_ms(fn, 1)
    check(ms / calls >= EVENTS_MIN_MS,
          f"torch.profiler recorded no kernel in three runs, and a call ({ms / calls:.4f} ms "
          f"by events) is too short for CUDA events to time the device")
    FALLBACKS[0] += 1
    print(f"device_ms: torch.profiler recorded no kernel in three runs; timed by CUDA "
          f"events instead ({ms / calls:.4f} ms a call): {ms:.4f} ms", flush=True)
    return ms


# ----------------------------------------------------------- small reference
def phase_small_reference(port, attention):
    """Full width, FP32, 128²: the card against the CPU plain path, first on
    K1, then on K4 (FLASH_ONLY_KV lowered) and K3 (VAE on the kernel
    backend), then on K5 and the folded norms (conv_backend="kernel_fold"),
    then with a 4-window prompt (emphasis, BREAK, clip_skip=2) on K2; then
    the sampler loops of slice B on K1: dpm++_3m_sde on Karras (4 steps),
    heun, restart, and ddim with eta 0.5 on the zero-terminal-SNR schedule
    and the trailing grid (3 steps)."""
    import numpy as np

    cfg_cpu = port.sd15_config(policy=port.FP32, attention_backend="plain")
    cfg_gpu = port.sd15_config(policy=port.FP32, attention_backend="kernel")
    t0 = time.perf_counter()
    cpu_models = seeded_cpu_models(port, cfg_cpu, 7)
    sds = {k: m.state_dict() for k, m in cpu_models.items()}
    gpu_models = port.build_models(cfg_gpu, device="cuda", state_dicts=sds)
    del sds
    tok = _tokenizer()
    kw = dict(uncond_prompt="", cfg_scale=7.5, seed=11, height=128, width=128,
              tokenizer=tok, return_latents=True)
    zero_snr = dataclasses.replace(cfg_gpu, zero_terminal_snr=True)

    def opts(sampler_name="ddpm", n_inference_steps=2, **more):
        return dict(sampler_name=sampler_name, n_inference_steps=n_inference_steps, **more)

    runs = [  # label, card config, FLASH_ONLY_KV, prompt, options, context
        ("K1", cfg_gpu, None, PROMPTS[0], opts(), 77),
        ("K4+K3", dataclasses.replace(cfg_gpu, vae_attention_backend="kernel"), 256,
         PROMPTS[0], opts(), 77),
        ("K1+K5 kernel_fold", dataclasses.replace(cfg_gpu, conv_backend="kernel_fold"),
         None, PROMPTS[0], opts(), 77),
        ("K1+K2 4-window prompt", cfg_gpu, None, LONG_PROMPT,
         opts(emphasis=True, clip_skip=2), 308),
        ("K1 dpm++_3m_sde karras", cfg_gpu, None, PROMPTS[0],
         opts("dpm++_3m_sde", 4, timestep_spacing="karras"), 77),
        ("K1 heun", cfg_gpu, None, PROMPTS[0], opts("heun", 3), 77),
        ("K1 restart", cfg_gpu, None, PROMPTS[0], opts("restart", 3), 77),
        ("K1 ddim eta 0.5, zero-terminal SNR, trailing", zero_snr, None, PROMPTS[0],
         opts("ddim", ddim_eta=0.5, timestep_spacing="trailing"), 77)]

    def ref_key(cfg, prompt, options):
        return cfg.zero_terminal_snr, prompt, tuple(sorted(options.items()))

    refs = {}
    for _, cfg, _, prompt, options, _ in runs:
        if ref_key(cfg, prompt, options) not in refs:
            refs[ref_key(cfg, prompt, options)] = port.generate(
                prompt, models=cpu_models, **options, **kw,
                config=dataclasses.replace(cfg_cpu, zero_terminal_snr=cfg.zero_terminal_snr))
    del cpu_models
    for label, cfg, flash_only, prompt, options, context in runs:
        steps = options["n_inference_steps"]
        evals = sampler_evals(options["sampler_name"], steps, 0)
        saved = attention.FLASH_ONLY_KV
        if flash_only is not None:
            attention.FLASH_ONLY_KV = flash_only
        try:
            want = expected_launches(cfg, 128, 128, steps=evals, img2img=False,
                                     flash_only=flash_only or FLASH_ONLY_KV, context=context)
            before = launch_counts()
            img_g, lat_g = port.generate(prompt, models=gpu_models, config=cfg,
                                         device="cuda", **options, **kw)
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in launch_counts().items()}
        finally:
            attention.FLASH_ONLY_KV = saved
        check(got == want, f"small run ({label}) launched {got}, want {want}")
        img_c, lat_c = refs[ref_key(cfg, prompt, options)]
        lat_db = psnr(lat_c, lat_g)
        img_db = psnr(img_c.astype(np.float32), img_g.astype(np.float32))
        print(f"small ({label}): full-width FP32 128² {steps} steps, {evals} UNet "
              f"evaluations, card vs CPU plain path: "
              f"latents PSNR {lat_db:.1f} dB, image PSNR {img_db:.1f} dB, launches "
              f"{got} ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(np.isfinite(lat_g).all(), "small run latents not finite")
        check(lat_db > 55.0, f"small run ({label}) latents PSNR {lat_db:.1f} dB <= 55")
        check(img_db > 40.0, f"small run ({label}) image PSNR {img_db:.1f} dB <= 40")
    del gpu_models
    torch.cuda.empty_cache()


def _tokenizer():
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import make_test_tokenizer

    words = sorted({w for p in PROMPTS for w in p.split()})
    return make_test_tokenizer(words, max_len=77)


# ------------------------------------------------------------ launch counts
def wrappers():
    """The kernel wrappers of the port by short name; each counts its
    launches in ``.launches``."""
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

    return {"K1": fa.flash_attention_bsc, "K2": fa.flash_attention_onepass,
            "K4": fa.flash_attention_streamed, "K3": fa.flash_attention_multipass,
            "K5": conv.scaled_silu_conv3x3}


def launch_counts():
    return {k: w.launches for k, w in wrappers().items()}


def zero_counts():
    for w in wrappers().values():
        w.launches = 0


#: head dims each kernel is built for on the card (ROADMAP §2); K3 takes
#: every multiple of 8 up to 512
K1_DH, K4_DH, K2_DH = (32, 40, 64, 80, 160), (16, 40, 64, 128), (16, 40, 64, 80, 128, 160)


def expected_kernel(kv, dh, *, cross, backend, flash_only=FLASH_ONLY_KV):
    """The kernel that the port's documented dispatch (ops/attention.py,
    ROADMAP §2) gives a non-causal attention call, written out here rather
    than read from ``attention.route``, so that the launch counts check the
    routing too: K4 (at its head dims) or K3 from ``flash_only`` KV tokens
    on; on the kernel backend from 256 KV tokens, K1 for self-attention at
    its head dims (K3 at other multiples of 8 up to 512), K2 for
    cross-attention over a padded KV up to 9216 at its head dims, and past
    that K4 at its head dims (K3 at the others: the reference read of
    768², slice E); otherwise materialized scores (None)."""
    k3 = dh % 8 == 0 and dh <= 512
    if kv >= flash_only:
        check(dh in K4_DH or k3, f"no kernel takes Dh {dh} at {kv} KV tokens")
        return "K4" if dh in K4_DH else "K3"
    if backend != "kernel" or kv < 256:
        return None
    if cross:
        if -(-kv // 128) * 128 > 9216:
            return "K4" if dh in K4_DH else "K3" if k3 else None
        check(dh in K2_DH, f"no request here has cross-attention over {kv} tokens at Dh {dh}")
        return "K2"
    return "K1" if dh in K1_DH else "K3" if k3 else None


def transformer_blocks(cfg, height, width, decoder=True):
    """Every transformer block of one UNet evaluation at ``height`` x
    ``width``, in order, from the UNet's plan: dicts of its grid (h, w), its
    tokens, channels and stacked layers, whether it is the bottleneck's
    (``mid``) and whether DeepCache's shallow pass runs it (``shallow``: the
    level-0 encoder blocks and the last decoder level); without the
    decoder's, those of a ControlNet (the encoder and the bottleneck)."""
    from pytorch_stable_diffusion_tpu_torch.models import unet

    u = cfg.unet
    h = height // cfg.vae.downsample_factor
    w = width // cfg.vae.downsample_factor
    blocks = []

    def add(level, c, layers, **where):
        hl, wl = h >> level, w >> level
        blocks.append(dict(dict(h=hl, w=wl, tokens=hl * wl, c=c, layers=layers, mid=False,
                                shallow=False), **where))

    level = 0
    for st in unet.encoder_plan(u)[1:]:
        if st["kind"] == "down":
            level += 1
        elif st["attn"]:
            add(level, st["c_out"], st["depth"], shallow=level == 0)
    add(level, u.level_channels[-1], u.depth_for(len(u.ch_mults) - 1), mid=True)
    dec = unet.decoder_plan(u) if decoder else []
    for i, st in enumerate(dec):
        if st["attn"]:
            add(level, st["c_out"], st["depth"], shallow=i >= len(dec) - u.num_res_blocks - 1)
        if st["upsample"]:
            level -= 1
    return blocks


def attention_blocks(cfg, height, width, decoder=True):
    """(tokens, channels, layers) of every transformer block of one UNet
    evaluation at ``height`` x ``width``, in order (:func:`transformer_blocks`)."""
    return [(b["tokens"], b["c"], b["layers"])
            for b in transformer_blocks(cfg, height, width, decoder)]


def self_attention_plan(cfg, block):
    """(sequences a lane, tokens a sequence) of a UNet self-attention of
    ``block`` under the config's ToMe and Hypertile (``unet.block_plans``,
    the static plan): ToMe attends over the tokens left after merging,
    Hypertile over each tile, one sequence a tile."""
    from pytorch_stable_diffusion_tpu_torch.models import unet

    tome_plan, ht = unet.block_plans(cfg.unet.tome, cfg.unet.hypertile, block["h"], block["w"])
    if tome_plan is not None:
        return 1, block["tokens"] - tome_plan[2]
    if ht is not None:
        return block["tokens"] // (ht[0] * ht[1]), ht[0] * ht[1]
    return 1, block["tokens"]


def deepcache_evals(sampler, steps, start, interval):
    """(full, shallow) UNet evaluations of a DeepCache request: an
    evaluation of step i is full when (i - start) % interval == 0; heun's
    corrector and the dpm2 family's midpoint are always shallow (and skipped
    on the final step, :func:`sampler_evals`); plms evaluates its grid
    points by ``pndm.eval_index``."""
    from pytorch_stable_diffusion_tpu_torch.sampling import pndm

    if sampler == "plms":
        idx = [min(pndm.eval_index(i, start), steps - 1) for i in range(start, steps + 1)]
    else:
        check(sampler in ONE_EVAL + TWO_EVAL, f"{sampler} does not compose with deepcache")
        idx = list(range(start, steps))
    full = sum((i - start) % interval == 0 for i in idx)
    return full, sampler_evals(sampler, steps, start) - full


def expected_launches(cfg, height, width, *, steps, img2img, flash_only=FLASH_ONLY_KV,
                      context=77, encodes=None, controlnets=0, reference=None, cfg_lanes=True,
                      pag=False, sag=False, shallow=0, tiling=False, canvas=None, sp=1):
    """Kernel launches of one request, derived from the UNet's plan (which
    stages carry attention, at which level, of how many stacked layers,
    at which head width; its res blocks), the length of the
    cross-attention context, the VAE's mid block and
    :func:`expected_kernel`.  ``encodes``: the VAE encodes besides the one
    decode (by default one with ``img2img``, else none; slice C3's: two
    for 9-channel inpainting with an init image, the image and the masked
    image, one for InstructPix2Pix's edit image).  Slice E: each of
    ``controlnets`` runs the encoder's and the bottleneck's attention and
    res blocks an evaluation; ``reference`` ("attn", "adain",
    "adain+attn") adds a capture pass an evaluation (a whole UNet's
    launches), the read's attention over twice the tokens where the mode
    reads attention (:func:`expected_kernel` of 2 x tokens on the cross
    path; without CFG, ``cfg_lanes`` False, it replaces the plain
    self-attention), and the reference image's encode.  Slice F: ``pag``
    adds one more pass an evaluation without the bottleneck's
    self-attention (the identity map); ``sag`` one more whole pass, with
    the main pass's bottleneck layer 0 materialized (its map is returned);
    ``shallow`` of the ``steps`` evaluations are DeepCache's shallow ones
    (only the blocks of :func:`transformer_blocks`'s ``shallow`` and those
    res blocks); the config's ToMe and Hypertile route each UNet
    self-attention by its sequence (:func:`self_attention_plan`), the
    ControlNet's by the whole grid; ``tiling`` runs no K5, nor does an
    int8 tier (``cfg.quant``, slice H2).  Slice G:
    ``steps`` counts every UNet call, a frame window's or a panorama
    window's each; ``canvas``, the (height, width) of a panorama's VAE
    where ``height`` x ``width`` is its window.  Slice H3a: the launches of
    one of ``sp`` model ranks under sequence parallelism, whose
    self-attentions take the rank's q rows over the whole KV (the cross
    path: K2, or K4/K3 past 9216 padded KV tokens) and whose res blocks run
    no K5; the VAE runs whole on every rank.  One launch
    serves every lane and every tile of an evaluation, so the lane count (1
    without CFG, 2 with it, 3 for InstructPix2Pix, n_and + 1 with AND) does
    not enter the counts; it enters the shapes phase 3 holds
    (:func:`plan_shapes`).  The CPU tests import it too."""
    from pytorch_stable_diffusion_tpu_torch.models import unet

    counts = {"K1": 0, "K2": 0, "K4": 0, "K3": 0, "K5": 0}

    def add(kernel, n):
        if kernel is not None:
            counts[kernel] += n

    u = cfg.unet
    h = height // cfg.vae.downsample_factor
    w = width // cfg.vae.downsample_factor
    # whole UNet passes an evaluation besides the main one: a reference
    # capture pass, SAG's degraded-latents pass; PAG's pass has no
    # bottleneck self-attention
    full = steps - shallow
    extra = (reference is not None) + sag
    n_net_blocks = len(attention_blocks(cfg, height, width, decoder=False))
    for i, blk in enumerate(transformer_blocks(cfg, height, width)):
        tokens, c, layers = blk["tokens"], blk["c"], blk["layers"]
        dh = c // u.heads_for(c)
        main = full + (shallow if blk["shallow"] else 0)
        net = steps * controlnets if i < n_net_blocks else 0
        k_self = expected_kernel(self_attention_plan(cfg, blk)[1], dh, cross=sp > 1,
                                 backend=cfg.attention_backend, flash_only=flash_only)
        k_net = expected_kernel(tokens, dh, cross=sp > 1, backend=cfg.attention_backend,
                                flash_only=flash_only)
        add(k_self, layers * (main + steps * extra + (steps * pag if not blk["mid"] else 0)))
        add(k_net, layers * net)
        if sag and blk["mid"]:  # the main pass's layer 0 returns its map
            add(k_self, -steps)
        add(expected_kernel(context, dh, cross=True, backend=cfg.attention_backend,
                            flash_only=flash_only),
            layers * (main + steps * (extra + pag) + net))
        if reference is not None and "attn" in reference:
            # the read attends over [own, banked] tokens (the cross path,
            # k/v from 2x the tokens); under CFG the plain self-attention of
            # the uncond lanes runs beside it, else not at all
            add(expected_kernel(2 * tokens, dh, cross=True, backend=cfg.attention_backend,
                                flash_only=flash_only), steps * layers)
            if not cfg_lanes:
                add(k_self, -steps * layers)
    if cfg.conv_backend in ("kernel", "kernel_fold") and not tiling and cfg.quant == "none" \
            and sp == 1:
        # both halves of every res block; a shallow pass's: level 0's and
        # the last decoder level's
        enc_blocks = sum(st["kind"] == "block" for st in unet.encoder_plan(u))
        per_pass = enc_blocks + 2 + len(unet.decoder_plan(u))
        counts["K5"] += 2 * (full * per_pass + shallow * (2 * u.num_res_blocks + 1)
                             + steps * ((extra + pag) * per_pass
                                        + controlnets * (enc_blocks + 2)))
    mid = cfg.vae.level_channels[-1]  # the VAE mid block: one head of Dh = channels
    if canvas is not None:
        h, w = (n // cfg.vae.downsample_factor for n in canvas)
    add(expected_kernel(h * w, mid, cross=False, backend=cfg.vae_attention_backend,
                        flash_only=flash_only),
        1 + (int(img2img) if encodes is None else encodes) + (reference is not None))
    return counts


def plan_shapes(cfg, height, width, lanes, context=77):
    """The shapes one UNet evaluation of ``lanes`` lanes at ``height`` x
    ``width`` gives K1, K2 and K5 on the kernel backends, from the UNet's
    plan and :func:`expected_kernel`, each with its launches an evaluation:
    {"K1": {(B, S, C, heads): n}, "K2": {(B, heads, S, KV, Dh): n},
    "K5": {(B, H, W, Cin, Cout): n}}; K1's under the config's ToMe (S the
    tokens left) and Hypertile (B the lanes times the tiles, S a tile's)."""
    out = {"K1": {}, "K2": {}, "K5": {}}

    def add(kernel, key, n):
        out[kernel][key] = out[kernel].get(key, 0) + n

    u = cfg.unet
    for blk in transformer_blocks(cfg, height, width):
        tokens, c, layers = blk["tokens"], blk["c"], blk["layers"]
        heads = u.heads_for(c)
        seqs, seq = self_attention_plan(cfg, blk)
        if expected_kernel(seq, c // heads, cross=False, backend="kernel") == "K1":
            add("K1", (lanes * seqs, seq, c, heads), layers)
        if expected_kernel(context, c // heads, cross=True, backend="kernel") == "K2":
            add("K2", (lanes, heads, tokens, context, c // heads), layers)
    for h, w, cin, cout in res_convs(cfg, height, width):
        add("K5", (lanes, h, w, cin, cout), 1)
    return out


#: slice C3's requests that give K1, K2 and K5 a lane count or a shape the
#: earlier slices' do not: (preset, height, width, lanes, context, request)
C3_PLANS = (("sd15_config", 512, 512, 1, 77, "h: LCM, no CFG"),
            ("sd15_config", 512, 512, 3, 77, "g: InstructPix2Pix"),
            ("sd15_config", 512, 512, 3, 308, "g: InstructPix2Pix, 4-window prompt"),
            ("sd15_config", 1024, 1024, 2, 77, "i: hires_fix's 1024² pass"),
            ("sd15_config", 512, 640, 2, 77, "e: outpaint's 640x512 canvas"),
            ("sdxl_config", 1024, 1024, 1, 77, "k: SDXL LCM, no CFG"))


def c3_shapes(kernel):
    """{shape: (launches an evaluation, request)} of ``kernel`` over
    :data:`C3_PLANS`."""
    import pytorch_stable_diffusion_tpu_torch as port

    out = {}
    for preset, height, width, lanes, context, label in C3_PLANS:
        for key, n in plan_shapes(getattr(port, preset)(), height, width, lanes,
                                  context)[kernel].items():
            out.setdefault(key, (n, label))
    return out


#: slice E's reference reads, whose attention over [own, banked] tokens takes
#: the cross path over twice the tokens (K2, or K4 past 9216 padded KV
#: tokens): (preset, height, width, lanes, request)
E_PLANS = (("sd15_config", 512, 512, 2, "e: reference attn 512²"),
           ("sd15_config", 768, 768, 2, "e': reference attn 768²"),
           ("sdxl_config", 1024, 1024, 2, "i: SDXL reference attn 1024²"))


def e_shapes(kernel):
    """{(B, H, Sq, KV, Dh): (launches an evaluation, request)} of ``kernel``
    (K2 or K4) in the reference reads of :data:`E_PLANS`, from the UNet's
    plan and :func:`expected_kernel`."""
    import pytorch_stable_diffusion_tpu_torch as port

    out = {}
    for preset, height, width, lanes, label in E_PLANS:
        cfg = getattr(port, preset)()
        plan = {}
        for tokens, c, layers in attention_blocks(cfg, height, width):
            heads = cfg.unet.heads_for(c)
            if expected_kernel(2 * tokens, c // heads, cross=True, backend="kernel") == kernel:
                key = (lanes, heads, tokens, 2 * tokens, c // heads)
                plan[key] = plan.get(key, 0) + layers
        for key, n in plan.items():
            out.setdefault(key, (n, label))
    return out


#: slice F's requests whose Hypertile or ToMe plans give K1 new shapes:
#: (preset, height, width, lanes, modes, request); a mode is ("hypertile",
#: tile) or ("tome", ratio), at the default 4096 min_tokens
F_PLANS = (("sd15_config", 512, 512, 2, ("hypertile", 32), "i: Hypertile 32, 512²"),
           ("sd15_config", 2048, 2048, 2, ("hypertile", 32), "m: fast preset, 2048²"),
           ("sd15_config", 2560, 2560, 2, ("hypertile", 32), "n: Hypertile 32, 2560²"),
           ("sdxl_config", 1024, 1024, 2, ("hypertile", 32), "o: SDXL Hypertile 32, 1024²"),
           ("sd15_config", 512, 512, 2, ("tome", 0.5), "j: ToMe 0.5, 512²"),
           ("sdxl_config", 1024, 1024, 2, ("tome", 0.5), "SDXL ToMe 0.5, 1024² (no request)"))


def with_mode(port, cfg, mode):
    """``cfg`` with a Hypertile or ToMe mode of :data:`F_PLANS`."""
    kind, value = mode
    return port.with_hypertile(cfg, value) if kind == "hypertile" else \
        port.with_tome(cfg, value)


def f_shapes(kernel):
    """{shape: (launches an evaluation, request)} of ``kernel`` over
    :data:`F_PLANS`."""
    import pytorch_stable_diffusion_tpu_torch as port

    out = {}
    for preset, height, width, lanes, mode, label in F_PLANS:
        cfg = with_mode(port, getattr(port, preset)(), mode)
        for key, n in plan_shapes(cfg, height, width, lanes)[kernel].items():
            out.setdefault(key, (n, label))
    return out


#: slice G's requests that give K1 and K5 a lane count the earlier slices'
#: do not: AnimateDiff's 16 frames in each CFG group (a 16-frame window of
#: (b) too): (preset, height, width, lanes, request)
G_PLANS = (("sd15_config", 512, 512, 32, "a: animate 16 frames x CFG, 512²"),)
#: the VAE mid blocks of slice G's decodes that K3 has not run at: (B, H,
#: Sq = Sk, Dh, launches a request, request)
G_K3 = ((1, 1, 131072, 512, 1, "d: the 2048x4096 panorama's decode"),
        (16, 1, 4096, 512, 1, "a: 16 frames' decode"),
        (24, 1, 4096, 512, 1, "b: 24 frames' decode"),
        (4, 1, 4096, 512, 6, "g: sd_upscale's chunks of 4 tiles, encode and decode"))


def g_shapes(kernel):
    """{shape: (launches an evaluation, request)} of ``kernel`` (K1, K5) over
    :data:`G_PLANS`."""
    import pytorch_stable_diffusion_tpu_torch as port

    out = {}
    for preset, height, width, lanes, label in G_PLANS:
        for key, n in plan_shapes(getattr(port, preset)(), height, width, lanes)[kernel].items():
            out.setdefault(key, (n, label))
    return out


#: slice H3a's requests: (height, width, lanes, model ranks, request); the
#: shapes K2, K3 and K4 take on a rank under sequence parallelism
SP_PLANS = ((512, 512, 2, 2, "H3a a: 512², 2 ranks"), (2048, 2048, 2, 2, "H3a b: 2048², 2 ranks"))


def sp_shapes(kernel):
    """{(B, H, Sq, KV, Dh): (launches a rank an evaluation, request)} of
    ``kernel`` (K2, K3 or K4) over :data:`SP_PLANS`: each rank's q rows
    (rank 0's ceil-sized block of the level's rows) over the level's whole
    KV, on the cross path of :func:`expected_kernel`."""
    import pytorch_stable_diffusion_tpu_torch as port

    out = {}
    for height, width, lanes, n, label in SP_PLANS:
        cfg = port.sd15_config()
        plan = {}
        for blk in transformer_blocks(cfg, height, width):
            heads = cfg.unet.heads_for(blk["c"])
            dh = blk["c"] // heads
            if expected_kernel(blk["tokens"], dh, cross=True, backend="kernel") == kernel:
                key = (lanes, heads, -(-blk["h"] // n) * blk["w"], blk["tokens"], dh)
                plan[key] = plan.get(key, 0) + blk["layers"]
        for key, n_eval in plan.items():
            out.setdefault(key, (n_eval, label))
    return out


#: samplers of one UNet evaluation a step, and of two but on the final step
#: (an Euler step there) — the samplers' documented schedules (ROADMAP §1)
ONE_EVAL = ("ddpm", "ddim", "euler", "euler_a", "lcm", "dpm++", "dpm++_sde",
            "dpm++_3m_sde", "unipc", "lms")
TWO_EVAL = ("heun", "dpm2", "dpm2_a", "dpm++_2s_a")


def sampler_evals(sampler, steps, start, iterations=None):
    """UNet evaluations of one request from start step ``start`` of
    ``steps``, from the sampler's documented schedule: n - s for the one-
    evaluation samplers, 2(n - s) - 1 for heun and the dpm2 family, n + 1 - s
    for plms, 2 an op of restart's plan from its img2img entry op, 3 a
    segment of dpm_fast's plan from its entry segment, 3 an iteration of
    dpm_adaptive (its ``iterations``, which ``sample`` reports)."""
    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm, dpm_fast, restart

    if sampler in ONE_EVAL:
        return steps - start
    if sampler in TWO_EVAL:
        return 2 * (steps - start) - 1
    if sampler == "plms":
        return steps + 1 - start
    if sampler == "restart":
        plan = restart.build_plan(ddpm.make_schedule(), steps)
        return 2 * (plan["n_ops"] - int(plan["op_start"][start]))
    if sampler == "dpm_fast":
        plan = dpm_fast.build_plan(ddpm.make_schedule(), steps)
        return 3 * (plan["m"] - int(plan["seg_start"][start]))
    check(sampler == "dpm_adaptive" and iterations is not None and 0 < iterations <= steps,
          f"{sampler}: {iterations} iterations for a bound of {steps}")
    return 3 * iterations


#: slice B's requests: sampler -> (timestep_spacing, steps)
SLICE_B = {"ddim": ("uniform", 10), "dpm++": ("karras", 10), "dpm++_sde": ("karras", 10),
           "dpm++_3m_sde": ("karras", 10), "dpm++_2s_a": ("uniform", 10),
           "euler": ("karras", 10), "euler_a": ("uniform", 10), "heun": ("karras", 10),
           "unipc": ("uniform", 10), "lcm": ("uniform", 4), "plms": ("uniform", 10),
           "lms": ("uniform", 10), "dpm2": ("karras", 10), "dpm2_a": ("karras", 10),
           "restart": ("uniform", 10), "dpm_fast": ("uniform", 10),
           "dpm_adaptive": ("uniform", 10)}


def phase_slice_b(port, request, base, init_image, zero_counts, read_path):
    """Slice B at 512², BF16, kernel attention, batch 1, CFG 7.5, seed 1337:
    each of the 17 samplers besides ddpm once (txt2img), img2img at strength
    0.6 with dpm++ on Karras and with restart, euler_a on conv_backend
    "kernel" (K5) and dpm++ with the 4-window prompt (K2); dpm++_sde and
    dpm_adaptive twice, bit-identical.  The counters are zeroed before each
    request and read after it; each request's launches must equal those of
    its UNet evaluations, counted from the sampler's schedule
    (:func:`sampler_evals`); dpm_adaptive's iterations are read from
    ``sample``'s report."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm, dpm_adaptive

    real_sample, iterations = dpm_adaptive.sample, []

    def recording(*args, **kwargs):
        out = real_sample(*args, **kwargs)
        iterations.append(len(out[1]))
        return out

    dpm_adaptive.sample = recording
    img2img = dict(input_image=init_image, strength=0.6)
    runs = [(s, s, sp, n, {}) for s, (sp, n) in SLICE_B.items()] + [
        # label, sampler, spacing, steps, options
        ("dpm++ img2img 0.6", "dpm++", "karras", 10, img2img),
        ("restart img2img 0.6", "restart", "uniform", 10, img2img),
        ("euler_a conv kernel", "euler_a", "uniform", 10,
         dict(config=dataclasses.replace(base["config"], conv_backend="kernel"))),
        ("dpm++ 4-window prompt", "dpm++", "karras", 10,
         dict(prompt=LONG_PROMPT, emphasis=True, clip_skip=2)),
        ("dpm++_sde again", "dpm++_sde", "karras", 10, {}),
        ("dpm_adaptive again", "dpm_adaptive", "uniform", 10, {})]
    images = {}
    try:
        for label, sampler, spacing, steps, options in runs:
            kw = {**base, "prompt": PROMPTS[0], "seed": 1337, "return_latents": True,
                  "sampler_name": sampler, "timestep_spacing": spacing,
                  "n_inference_steps": steps, **options}
            start = ddpm.start_step_for_strength(steps, kw["strength"]) \
                if "input_image" in kw else 0
            iterations.clear()
            zero_counts()
            images[label], _ = request(
                f"B {label}: {sampler}, {spacing}", lambda: port.generate(**kw),
                size=512, steps=steps, n_images=1, img2img="input_image" in kw,
                config=kw["config"], context=308 if kw["prompt"] == LONG_PROMPT else 77,
                evals=lambda: sampler_evals(sampler, steps, start,
                                            iterations[-1] if iterations else None))
            read_path()
    finally:
        dpm_adaptive.sample = real_sample
    for label in ("dpm++_sde", "dpm_adaptive"):
        check(np.array_equal(images[label], images[f"{label} again"]),
              f"{label}: the same seed gave a different image")
    print("requests B: dpm++_sde and dpm_adaptive again == first, bit-identical", flush=True)


def phase_step(models, cfg, card, size=2048, context=77, batch=2, label="SD-1.5"):
    """One UNet evaluation of ``cfg``'s family at ``size``² of CFG batch
    ``batch`` under a ``context``-token context (and random added
    conditioning, SDXL; the UNet's input channels, 8 for InstructPix2Pix;
    LCM's guidance embedding where the UNet takes one): its wall time, its
    device busy share under torch.profiler, and the device time of K1, K4,
    K2 and K5 in it."""
    from pytorch_stable_diffusion_tpu_torch.models import unet

    g = torch.Generator(device="cuda").manual_seed(3)
    dtype = cfg.policy.compute_dtype
    lat = size // cfg.vae.downsample_factor
    x = torch.randn(batch, cfg.unet.in_channels, lat, lat, device="cuda", generator=g) \
        .to(dtype).contiguous(memory_format=torch.channels_last)
    ctx = torch.randn(batch, context, cfg.unet.d_context, device="cuda", generator=g).to(dtype)
    add = None if cfg.unet.add_embed_dim is None else \
        torch.randn(batch, cfg.unet.add_embed_dim, device="cuda", generator=g)
    t = torch.tensor(500.0, device="cuda")
    t_cond = None if cfg.unet.time_cond_dim is None else \
        unet.guidance_scale_embedding(7.0, cfg.unet.time_cond_dim, device="cuda")

    def step():
        with torch.inference_mode():
            return models["diffusion"](x, ctx, t, cfg.policy,
                                       attention_backend=cfg.attention_backend,
                                       conv_backend=cfg.conv_backend, add_cond=add,
                                       t_cond=t_cond)

    return profile_eval(step, card, f"step {label} ({size}², batch {batch}, {context}-token "
                                    f"context, {cfg.conv_backend}): one UNet evaluation")


def profile_eval(step, card, what):
    """``step`` (one evaluation) timed by the wall clock, then profiled: its
    device busy share under torch.profiler, and the device time of K1, K4,
    K2 and K5 in it; printed after ``what``; -> (wall s, device busy s)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # kernel rows only: an operator's row also carries its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    # K1 and K4 share the bf16 template attention_tc_kernel<Dh, warpgroups>:
    # by head dim, at 2048² Dh 40 is K4 (level 1) and Dh 80/160 K1; at 512²
    # all three are K1
    def kernel_of(key):
        tc = re.search(r"attention_tc_kernel<(\d+),", key)
        if tc:
            return f"tc<{tc.group(1)}>"
        return next((label for label, name in (("K1 fp32", "bsc_fp32_kernel"),
                                               ("K4 fp32", "streamed_fp32_kernel"),
                                               ("K2", "onepass"), ("K5", "conv_tc_kernel"))
                     if name in key), None)

    times = {}
    for e in rows:
        kernel = kernel_of(e.key)
        if kernel:
            times[kernel] = times.get(kernel, 0.0) + e.self_device_time_total / 1e6
    parts = [f"{kernel} {t * 1e3:.3f} ms "
             f"({f'{t / busy:.3f}' if busy > 0 else 'not measured'} of the device time)"
             for kernel, t in sorted(times.items())]
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:5]
    share = f"{busy / prof_wall:.3f}" if busy > 0 else "not measured"
    print(f"{what} {wall:.4f} s wall; profiled {prof_wall:.4f} s wall, {busy:.4f} s "
          f"device busy, busy share {share}, {launches} kernels; {'; '.join(parts)}; top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms" for e in top)
          + f"  [{card}]", flush=True)
    return wall, busy


def phase_vae(models, cfg, card, size=2048):
    """One VAE decode of a ``size``² image (its mid block on K3 at 65536
    tokens): wall time, and the device time of K3 and of everything under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(6)
    lat = size // cfg.vae.downsample_factor
    z = torch.randn(1, 4, lat, lat, device="cuda", generator=g).contiguous(
        memory_format=torch.channels_last)

    def decode():
        with torch.inference_mode():
            return models["decoder"](z, cfg.policy,
                                     attention_backend=cfg.vae_attention_backend,
                                     reference_quirks=cfg.reference_quirks)

    decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    k3 = sum(e.self_device_time_total for e in rows if "multipass" in e.key) / 1e3
    dev = (f"{busy:.2f} ms device, K3 {k3:.2f} ms device" if busy > 0
           else "device time not measured (the profiler recorded no kernel)")
    print(f"vae ({size}², batch 1, decode): {wall:.4f} s wall, {dev}  [{card}]", flush=True)


# ------------------------------------------------------------------ slice D
class HostPeak:
    """Peak VmRSS of this process while the block runs, sampled every 2 ms
    by a thread, and its growth over the start.  VmRSS counts the pages of
    a memory-mapped file that were read (the card machine's /proc has no
    RssAnon to tell them apart)."""

    def __enter__(self):
        import threading

        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss():
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) * 1024 for line in f
                        if line.startswith("VmRSS:"))

    def _poll(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    def text(self):
        return (f"peak host VmRSS {self.peak / 2**30:.2f} GiB "
                f"(+{(self.peak - self.start) / 2**30:.2f} over the start)")


def equal_to_file(models, cfg, want, label):
    """Every parameter of ``models`` (on the card) against ``want`` (the
    CompVis tensors on the card), bit for bit."""
    from pytorch_stable_diffusion_tpu_torch.weights import convert

    got = convert.deconvert(models, cfg)
    check(set(got) == set(want), f"{label}: {len(set(got) ^ set(want))} keys differ")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    check(not bad, f"{label}: {len(bad)} parameters differ from the file (first {bad[:3]})")
    return len(want)


def bf16_within_one_ulp(got, ref):
    """Elements of bf16 ``got`` equal to bf16 ``ref``, and the largest gap
    in units of ref's last place (one bf16 ulp: 2^(e-8) for |ref| = m·2^e,
    m in [0.5, 1))."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(r)
    ulps = ((g - r).abs() / torch.ldexp(torch.ones_like(r), e - 8)).max().item()
    return (g == r).sum().item(), ulps


def lora_file(models, cfg, path, g):
    """A kohya LoRA over every UNet and text-encoder conv and linear target
    of the port's diffusers rules (SDXL: ``lora_te1_`` for CLIP-L,
    ``lora_te2_`` for bigG), rank 8, alpha 4, fp16 factors; -> the file's
    factors by target, on the CPU in fp32."""
    from pytorch_stable_diffusion_tpu_torch.weights import lora, save

    sds = {name: models[name].state_dict() for name in ("clip", "clip2", "diffusion")
           if name in models}
    tensors, factors = {}, {}
    prefix = {"unet": "lora_unet_", "text_encoder": "lora_te1_" if "clip2" in models
              else "lora_te_", "text_encoder_2": "lora_te2_"}
    for dotted, targets in sorted(lora._weight_targets(cfg).items()):
        model, dst, kind = targets[0]
        w = sds[model][dst]
        if kind == "linear_t":  # the text projection, kept (in, out); the file's is (out, in)
            w = w.t()
        rank = 8
        down_shape = (rank,) + tuple(w.shape[1:])
        up_shape = (w.shape[0], rank) + ((1, 1) if w.dim() == 4 else ())
        down = (torch.randn(down_shape, device="cuda", generator=g) * 0.02).half()
        up = (torch.randn(up_shape, device="cuda", generator=g) * 0.02).half()
        root, rest = dotted.split(".", 1)
        name = prefix[root] + rest.replace(".", "_")
        tensors[f"{name}.lora_down.weight"] = down
        tensors[f"{name}.lora_up.weight"] = up
        tensors[f"{name}.alpha"] = torch.tensor(4.0, dtype=torch.float16)
        factors[(model, dst)] = (down.float().cpu(), up.float().cpu())
    save.write_safetensors(tensors, path)
    return factors


def hypernetwork_file(path, width=768):
    """An A1111 hypernetwork .pt for one context width, layer structure
    1-2-1 (width -> 2·width -> width), relu; the k-net with a LayerNorm
    after its first Linear (add_layer_norm), the v-net without; Sequential
    indices with A1111's gaps for the parameterless modules."""
    g = torch.Generator().manual_seed(13)

    def lin(o, i):
        return torch.randn(o, i, generator=g) * (0.5 / i ** 0.5), torch.randn(o, generator=g) * 0.01

    w0, b0 = lin(2 * width, width)
    w3, b3 = lin(width, 2 * width)
    k_net = {"linear.0.weight": w0, "linear.0.bias": b0,
             "linear.1.weight": 1.0 + 0.1 * torch.randn(2 * width, generator=g),
             "linear.1.bias": 0.1 * torch.randn(2 * width, generator=g),
             "linear.3.weight": w3, "linear.3.bias": b3}
    w0, b0 = lin(2 * width, width)
    w2, b2 = lin(width, 2 * width)
    v_net = {"linear.0.weight": w0, "linear.0.bias": b0,
             "linear.2.weight": w2, "linear.2.bias": b2}
    torch.save({width: (k_net, v_net), "name": "smoke", "layer_structure": [1, 2, 1],
                "activation_func": "relu", "add_layer_norm": True, "activate_output": False,
                "use_dropout": False, "step": 1}, path)


def phase_slice_d(port, card, request, zero_counts, read_path):
    """Slice D at full width, BF16, kernel attention, on files written in
    the real formats to a temporary directory (see the module docstring,
    phase 6, slice D); -> the directory (kept) with the fp16 checkpoint and
    the tokenizer's files, which slice I reads again."""
    import json
    import os
    import shutil
    import tempfile

    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.models import assemble
    from pytorch_stable_diffusion_tpu_torch.ops import attention
    from pytorch_stable_diffusion_tpu_torch.weights import (convert, diffusers, save,
                                                            stream)

    cfg = port.sd15_config(policy=port.BF16, attention_backend="kernel")
    cfg_k5 = dataclasses.replace(cfg, conv_backend="kernel")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_d_")
    d = tmp.name
    tok = _tokenizer()
    vocab, merges = _tokenizer_files(tok, d)

    # 1. the full model from a .safetensors file, eager and streamed
    t0 = time.perf_counter()
    file16 = {k: v.half() for k, v in
              convert.synthetic_state_dict(cfg, seed=0, device="cuda").items()}
    n_params = sum(v.numel() for v in file16.values())
    ckpt = os.path.join(d, "sd15.safetensors")
    save.write_safetensors(file16, ckpt)
    want = {k: v.to(torch.bfloat16) for k, v in file16.items()}
    del file16
    print(f"D files: synthetic SD-1.5 state dict, {n_params} parameters, written as fp16 "
          f".safetensors ({os.path.getsize(ckpt) / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(n_params == sum(SD15_COUNTS.values()), f"D: {n_params} parameters in the file")
    with HostPeak() as peak:
        t = time.perf_counter()
        sd = port.StableDiffusion.from_checkpoint(ckpt, vocab, merges, config=cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    n = equal_to_file(sd.models, cfg, want, "from_checkpoint")
    print(f"D load from_checkpoint (file -> card, eager): {dt:.2f} s, {peak.text()}; "
          f"{n} tensors equal the file's fp16 values cast to bf16, bit for bit  [{card}]",
          flush=True)
    with HostPeak() as peak:
        t = time.perf_counter()
        streamed = assemble(cfg, stream.load_sd_checkpoint_streamed(ckpt, cfg))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    equal_to_file(streamed, cfg, want, "load_sd_checkpoint_streamed")
    print(f"D load load_sd_checkpoint_streamed (file -> card, a tensor at a time): "
          f"{dt:.2f} s, {peak.text()}; every tensor equal, bit for bit  [{card}]", flush=True)
    del streamed, want

    kw = dict(uncond_prompt="", cfg_scale=7.5, sampler_name="dpm++", timestep_spacing="karras",
              n_inference_steps=20, seed=1337, height=512, width=512, return_latents=True)

    def run(label, bundle, prompt=PROMPTS[0], config=cfg_k5, context=77, **more):
        zero_counts()
        out = request(f"D {label}", lambda: bundle.txt2img(prompt, config=config,
                                                           **{**kw, **more}),
                      size=512, steps=20, n_images=1, config=config, context=context)
        read_path()
        return out[0]

    # 2. a .ckpt VAE (another seed's), read by the restricted unpickler
    other = port.build_models(cfg, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(1))
    vae_ckpt = os.path.join(d, "vae.ckpt")
    vae_sd = {k[len("first_stage_model."):]: v.float().cpu()
              for k, v in convert.deconvert(other, cfg).items()
              if k.startswith("first_stage_model.")}
    torch.save({"state_dict": vae_sd}, vae_ckpt)
    t = time.perf_counter()
    sd_vae = sd.with_vae(vae_ckpt)
    torch.cuda.synchronize()
    print(f"D with_vae (.ckpt, {len(vae_sd)} tensors, file -> card): "
          f"{time.perf_counter() - t:.2f} s  [{card}]", flush=True)
    for name in ("encoder", "decoder"):
        for k, v in sd_vae.models[name].state_dict().items():
            check(torch.equal(v, other[name].state_dict()[k]), f"with_vae: {name}.{k}")
    cfg_vae = dataclasses.replace(cfg_k5, vae_attention_backend="kernel")
    run("txt2img, with_vae .ckpt VAE, vae_attention_backend=kernel (K3)", sd_vae,
        config=cfg_vae)
    del sd_vae, vae_sd
    os.remove(vae_ckpt)

    # 3. the base request
    base = run("txt2img dpm++ karras 20 steps, conv_backend=kernel", sd)

    # 4. LoRA
    lora_path = os.path.join(d, "lora.safetensors")
    factors = lora_file(sd.models, cfg, lora_path, torch.Generator(device="cuda").manual_seed(3))
    t = time.perf_counter()
    sd_lora = sd.with_lora(lora_path)
    torch.cuda.synchronize()
    print(f"D with_lora: {len(factors)} targets (rank 8, alpha 4), file read and merged on "
          f"the card in {time.perf_counter() - t:.2f} s  [{card}]", flush=True)
    exact = total = 0
    worst = 0.0
    for (model, dst), (down, up) in factors.items():
        w = sd.models[model].state_dict()[dst]
        delta = (up.reshape(up.shape[0], 8) @ down.reshape(8, -1)).reshape(w.shape)
        ref = (w.float().cpu() + delta * (1.0 * 4.0 / 8)).to(torch.bfloat16)
        got = sd_lora.models[model].state_dict()[dst].cpu()
        eq, ulps = bf16_within_one_ulp(got, ref)
        exact, total, worst = exact + eq, total + ref.numel(), max(worst, ulps)
    print(f"D LoRA merge on the card vs the CPU fp32 merge cast to bf16: {exact}/{total} "
          f"elements equal, the others within {worst:.2f} ulp (tolerance 1 bf16 ulp)",
          flush=True)
    check(worst <= 1.0, f"LoRA merge: {worst:.2f} bf16 ulps from the CPU merge")
    lora_img = run("txt2img with_lora", sd_lora)
    check(not np.array_equal(lora_img, base), "with_lora: the image did not change")
    zero_img = run("txt2img with_lora(scale=0)", sd.with_lora(lora_path, scale=0.0))
    check(np.array_equal(zero_img, base), "with_lora(scale=0): not bit-identical to the base")
    os.remove(lora_path)
    del sd_lora

    # 5. textual inversion: an A1111 .pt of 2 vectors
    ti_path = os.path.join(d, "sd-toy.pt")
    torch.save({"string_to_param": {"*": torch.randn(2, 768, generator=torch.Generator()
                                                     .manual_seed(4)) * 0.4},
                "name": "sd-toy", "step": 1}, ti_path)
    sd_ti = sd.with_textual_inversion(ti_path)
    ti_prompt = "a photograph of sd-toy riding a horse"
    ids = sd_ti.tokenizer.encode(ti_prompt)
    check(sum(i >= 49408 for i in ids) == 2, f"textual inversion: token ids {ids[:12]}")
    check(sd_ti.config.clip.vocab_size == 49410, "textual inversion: vocab size")
    ti_img = run("txt2img with_textual_inversion (trigger in the prompt)", sd_ti, ti_prompt,
                 config=dataclasses.replace(cfg_k5, clip=sd_ti.config.clip))
    plain_img = run("txt2img, the same prompt without the embedding", sd, ti_prompt)
    check(not np.array_equal(ti_img, plain_img), "textual inversion: the image did not change")
    del sd_ti

    # 6. hypernetwork under a 4-window prompt: K2 on separate k/v allocations
    hn_path = os.path.join(d, "smoke-hn.pt")
    hypernetwork_file(hn_path)
    sd_hn = sd.with_hypernetwork(hn_path, strength=0.7)
    long_kw = dict(context=308, emphasis=True, clip_skip=2)
    separate = []
    real_k2 = attention.flash_attention_onepass

    def k2_spy(q, k, v, **kwargs):
        separate.append(k.untyped_storage().data_ptr() != v.untyped_storage().data_ptr())
        return real_k2(q, k, v, **kwargs)

    attention.flash_attention_onepass = k2_spy
    try:
        hn_img = run("txt2img with_hypernetwork(0.7), 4-window prompt (K2)", sd_hn,
                     LONG_PROMPT, **long_kw)
        check(len(separate) == 16 * 20 and all(separate),
              f"hypernetwork: {sum(separate)} of {len(separate)} K2 calls on separate k/v")
        separate.clear()
        long_img = run("txt2img 4-window prompt, no hypernetwork", sd, LONG_PROMPT, **long_kw)
        check(len(separate) == 16 * 20 and not any(separate),
              "without a hypernetwork K2 took k/v from separate allocations")
        hn0 = run("txt2img with_hypernetwork(strength=0), 4-window prompt", sd_hn.with_hypernetwork(
            hn_path, strength=0.0), LONG_PROMPT, **long_kw)
    finally:
        attention.flash_attention_onepass = real_k2
    check(not np.array_equal(hn_img, long_img), "hypernetwork: the image did not change")
    check(np.array_equal(hn0, long_img), "hypernetwork strength 0: not bit-identical")
    del sd_hn

    # 7. merge
    t = time.perf_counter()
    merged = sd.merged_with(other, alpha=0.3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    n = 0
    for name in ("clip", "encoder", "decoder", "diffusion"):
        sa, sb = sd.models[name].state_dict(), other[name].state_dict()
        for k, v in merged.models[name].state_dict().items():
            ref = ((1.0 - 0.3) * sa[k].float() + 0.3 * sb[k].float()).to(sa[k].dtype)
            check(torch.equal(v, ref), f"merged_with: {name}.{k}")
            n += 1
    print(f"D merged_with(alpha=0.3): {dt:.2f} s; {n} tensors equal (1-a)·A + a·B in fp32 "
          f"cast to bf16  [{card}]", flush=True)
    del merged, other

    # 8. generate_many: 6 prompts in chunks of 4
    prompts = PROMPTS + PROMPTS[:2]
    many_kw = {k: v for k, v in kw.items() if k not in ("uncond_prompt", "return_latents")}
    zero_counts()
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            many = request("D generate_many 6 prompts, batch_size=4 (2 chunks, one padded)",
                           lambda: sd.generate_many(prompts, batch_size=4, config=cfg_k5,
                                                    **many_kw),
                           size=512, steps=2 * 20, n_images=6, config=cfg_k5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    read_path()
    syncs = [str(w.message).splitlines()[0] for w in syncs
             if "called a synchronizing CUDA operation" in str(w.message)]
    first4 = sd.generate_batch(PROMPTS, config=cfg_k5, **many_kw)
    check(np.array_equal(many[:4], first4), "generate_many: chunk 0 != generate_images")
    check(not np.array_equal(many[4], many[0]), "generate_many: chunk 1 repeated chunk 0")
    print(f"D generate_many: (6, 512, 512, 3); chunk 0 == generate_images bit-identical; "
          f"prompt 0 in chunk 1 differs from chunk 0; host syncs in the call: {len(syncs)} "
          f"({'; '.join(sorted(set(syncs)))[:300]})", flush=True)
    check(len(syncs) <= 1, f"generate_many: {len(syncs)} host syncs (one, the final copy, "
                           f"expected)")

    # 9. a diffusers directory and the save round trip
    unet_sd, vae_sd, te_sd = diffusers.deconvert_diffusers(sd.models, cfg)
    root = os.path.join(d, "diffusers")
    for sub, fname, tensors in (("unet", "diffusion_pytorch_model", unet_sd),
                                ("vae", "diffusion_pytorch_model", vae_sd),
                                ("text_encoder", "model", te_sd)):
        os.makedirs(os.path.join(root, sub))
        save.write_safetensors(tensors, os.path.join(root, sub, f"{fname}.safetensors"))
    del unet_sd, vae_sd, te_sd
    t = time.perf_counter()
    loaded = diffusers.load_diffusers_pipeline(root, cfg)
    dt = time.perf_counter() - t
    n = 0
    for name, sd_ in loaded.items():
        for k, v in sd.models[name].state_dict().items():
            check(torch.equal(sd_[k].to("cuda"), v), f"diffusers: {name}.{k}")
            n += 1
    print(f"D load_diffusers_pipeline (bf16 diffusers tree -> host): {dt:.2f} s; {n} tensors "
          f"equal the source  [{card}]", flush=True)
    del loaded
    path = os.path.join(d, "saved.safetensors")
    save.save_safetensors(sd.models, cfg, path, dtype=torch.bfloat16)
    again = convert.load_sd_checkpoint(path, cfg)
    for name, sd_ in again.items():
        for k, v in sd.models[name].state_dict().items():
            check(torch.equal(sd_[k].to("cuda"), v), f"save round trip: {name}.{k}")
    print("D save_safetensors -> load_sd_checkpoint: bit-identical", flush=True)
    del again, sd
    os.remove(path)
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    # slice I loads the checkpoint again through the top-level names
    return {"dir": tmp, "ckpt": ckpt, "vocab": vocab, "merges": merges}


# ----------------------------------------------------------------- slice C2
def phase_small_c2(port, attention):
    """Full width, FP32, 256², 1 DDPM+CFG step, the card against the CPU
    plain path on the same seeded weights and noise: SDXL (K1 at level 1's
    256 tokens, Dh 64; the VAE's mid block on K3), and SD-2.1 768-v with
    FLASH_ONLY_KV lowered to 1024 so that K4 carries level 1 (1024 tokens,
    Dh 64), K1 level 2 and K3 the VAE.  Prints the host memory and time the
    CPU side takes."""
    import ctypes
    import gc

    import numpy as np

    tok = _tokenizer()
    kw = dict(uncond_prompt="a dog", cfg_scale=5.0, seed=17, height=256, width=256,
              tokenizer=tok, return_latents=True, sampler_name="ddpm", n_inference_steps=1)
    kernels = dict(attention_backend="kernel", vae_attention_backend="kernel")
    for label, make, flash_only in (("SDXL", port.sdxl_config, None),
                                    ("SD-2.1 768-v", port.sd21_config, 1024)):
        t0 = time.perf_counter()
        cfg_cpu = make(policy=port.FP32)
        cfg_gpu = make(policy=port.FP32, **kernels)
        with HostPeak() as peak:
            cpu = seeded_cpu_models(port, cfg_cpu, 29)
            t_build = time.perf_counter() - t0
            t1 = time.perf_counter()
            img_c, lat_c = port.generate(PROMPTS[0], models=cpu, config=cfg_cpu, device="cpu",
                                         **kw)
            t_cpu = time.perf_counter() - t1
            gpu = port.build_models(cfg_gpu, device="cuda",
                                    state_dicts={k: m.state_dict() for k, m in cpu.items()})
        del cpu
        gc.collect()
        ctypes.CDLL("libc.so.6").malloc_trim(0)  # so the next family's peak starts clean
        saved = attention.FLASH_ONLY_KV
        if flash_only is not None:
            attention.FLASH_ONLY_KV = flash_only
        try:
            want = expected_launches(cfg_gpu, 256, 256, steps=1, img2img=False,
                                     flash_only=flash_only or FLASH_ONLY_KV)
            before = launch_counts()
            img_g, lat_g = port.generate(PROMPTS[0], models=gpu, config=cfg_gpu,
                                         device="cuda", **kw)
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in launch_counts().items()}
        finally:
            attention.FLASH_ONLY_KV = saved
        del gpu
        torch.cuda.empty_cache()
        lat_db = psnr(lat_c, lat_g)
        img_db = psnr(img_c.astype(np.float32), img_g.astype(np.float32))
        print(f"small C2 ({label}): full-width FP32 256², 1 DDPM step, CFG 5, card vs CPU "
              f"plain path: latents PSNR {lat_db:.1f} dB, image PSNR {img_db:.1f} dB, "
              f"launches {got}; CPU side: models built in {t_build:.1f} s, the request in "
              f"{t_cpu:.1f} s, {peak.text()} ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(got == want, f"small C2 ({label}) launched {got}, want {want}")
        check(np.isfinite(lat_g).all(), f"small C2 ({label}): latents not finite")
        check(lat_db > 55.0, f"small C2 ({label}) latents PSNR {lat_db:.1f} dB <= 55")
        check(img_db > 40.0, f"small C2 ({label}) image PSNR {img_db:.1f} dB <= 40")


def sgm_file(cfg, path, seed):
    """A full-width SDXL state dict in the sgm key schema (the port's
    ``deconvert``: (C, C) proj_in/proj_out, the bigG q/k/v fused into
    in_proj), with the towers' extras real files carry (bigG's
    ``logit_scale``, CLIP-L's ``position_ids``), written as fp16
    ``.safetensors``; -> the written tensors, on the card in bf16."""
    from pytorch_stable_diffusion_tpu_torch.weights import convert, save

    file16 = {k: v.half() for k, v in
              convert.synthetic_state_dict(cfg, seed=seed, device="cuda").items()}
    proj = [k for k in file16 if k.endswith("proj_in.weight") and "diffusion_model" in k]
    check(proj and all(file16[k].dim() == 2 for k in proj), "sgm file: proj_in not (C, C)")
    extras = {"conditioner.embedders.1.model.logit_scale": torch.tensor(4.6052).half(),
              "conditioner.embedders.0.transformer.text_model.embeddings.position_ids":
                  torch.arange(77, dtype=torch.int64)[None]}
    save.write_safetensors({**file16, **extras}, path)
    return {k: v.to(torch.bfloat16) for k, v in file16.items()}, len(proj)


def phase_slice_c2(port, card, request, zero_counts, read_path):
    """Slice C2 at full width, BF16, kernel attention, conv and VAE (the
    module docstring, phase 6, slice C2)."""
    import os
    import tempfile

    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.models import assemble, param_count
    from pytorch_stable_diffusion_tpu_torch.weights import lora, stream

    kernels = dict(attention_backend="kernel", conv_backend="kernel",
                   vae_attention_backend="kernel")
    xl_cfg = port.sdxl_config(policy=port.BF16, **kernels)
    t0 = time.perf_counter()
    xl = port.build_models(xl_cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(21))
    counts = {k: param_count(m) for k, m in xl.items()}
    check(counts == SDXL_COUNTS, f"SDXL parameter counts {counts}")
    torch.cuda.synchronize()
    print(f"C2 model: SDXL base BF16 on the card, counts {counts} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    tok = _tokenizer()
    base = dict(uncond_prompt="", cfg_scale=5.0, sampler_name="dpm++", timestep_spacing="karras",
                n_inference_steps=10, tokenizer=tok, device="cuda", height=1024, width=1024,
                return_latents=True, seed=1337)

    def run(label, fn, family, *, size=1024, steps=10, n_images=1, config=xl_cfg, context=77):
        zero_counts()
        out = request(f"C2 {label}", fn, size=size, steps=steps, n_images=n_images,
                      config=config, context=context, per_eval=C2_PER_EVAL[family])
        read_path()
        return out

    def xl_request(prompt=PROMPTS[0], models=None, **more):
        return lambda: port.generate(prompt, models=models or xl,
                                     **{**base, "config": xl_cfg, **more})

    a, lat_a = run("a SDXL 1024² dpm++ karras 10 steps, CFG 5, seed 1337", xl_request(), "sdxl")
    a2, _ = run("a' the same again", xl_request(), "sdxl")
    check(np.array_equal(a, a2), "SDXL: the same seed gave a different image")
    long_img, _ = run("b 4-window prompt (emphasis, BREAK): K2", xl_request(
        LONG_PROMPT, emphasis=True), "sdxl", context=308)
    micro, _ = run("c original_size=(2048, 2048), crop_coords=(64, 64)", xl_request(
        original_size=(2048, 2048), crop_coords=(64, 64)), "sdxl")
    check(not np.array_equal(micro, a), "micro-conditioning: the image did not change")
    print(f"requests C2: a' == a bit-identical; not gated: b vs a "
          f"{psnr(long_img.astype(np.float32), a.astype(np.float32)):.1f} dB, c vs a "
          f"{psnr(micro.astype(np.float32), a.astype(np.float32)):.1f} dB", flush=True)

    # the refiner over the base's latents (no VAE encode)
    rf_cfg = port.sdxl_refiner_config(policy=port.BF16, **kernels)
    rf = port.build_models(rf_cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(22))
    start = 10 - int(10 * 0.3)
    refined, _ = run("d refiner 1024² over a's latents (init_latents), strength 0.3",
                     lambda: port.generate(PROMPTS[0], models=rf, init_latents=lat_a,
                                           strength=0.3, **{**base, "config": rf_cfg}),
                     "refiner", steps=10 - start, config=rf_cfg)
    check(not np.array_equal(refined, a), "refiner: the image did not change")
    del rf
    torch.cuda.empty_cache()

    # SD-2.1 768-v
    v_cfg = port.sd21_config(policy=port.BF16, **kernels)
    v_models = port.build_models(v_cfg, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(23))
    run("e SD-2.1 768-v 768² euler_a 10 steps, trailing",
        lambda: port.generate(PROMPTS[1], models=v_models, **{
            **base, "config": v_cfg, "height": 768, "width": 768, "sampler_name": "euler_a",
            "timestep_spacing": "trailing", "cfg_scale": 7.0}),
        "sd21", size=768, config=v_cfg)
    del v_models
    torch.cuda.empty_cache()

    # generate_many: 3 prompts at batch 2 (2 chunks of CFG batch 4); the VAE on
    # the plain backend (one K3 call a decode would count per chunk)
    many_cfg = dataclasses.replace(xl_cfg, vae_attention_backend="plain")
    many_kw = {k: v for k, v in base.items() if k not in ("uncond_prompt", "return_latents")}
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            many = run("f generate_many 3 prompts, batch_size=2 (2 chunks, one padded)",
                       lambda: port.generate_many(PROMPTS[:3], batch_size=2, models=xl,
                                                  **{**many_kw, "config": many_cfg}),
                       "sdxl", steps=2 * 10, n_images=3, config=many_cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in syncs
             if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"C2 generate_many: {many.shape}; host syncs in the call: {len(syncs)}", flush=True)
    check(len(syncs) <= 1, f"C2 generate_many: {len(syncs)} host syncs (one, the final copy, "
                           f"expected)")

    # files: an sgm .safetensors, eager and streamed; a kohya LoRA over both
    # towers and the UNet; a dual-tower embedding
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_c2_")
    d = tmp.name
    ckpt = os.path.join(d, "sdxl.safetensors")
    t = time.perf_counter()
    want, n_proj = sgm_file(xl_cfg, ckpt, seed=24)
    print(f"C2 files: synthetic SDXL state dict, {sum(v.numel() for v in want.values())} "
          f"parameters, sgm keys, {n_proj} proj_in as (C, C), bigG logit_scale, written as "
          f"fp16 .safetensors ({os.path.getsize(ckpt) / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    vocab, merges = _tokenizer_files(tok, d)
    with HostPeak() as peak:
        t = time.perf_counter()
        sd = port.StableDiffusion.from_checkpoint(ckpt, vocab, merges, config=xl_cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    n = equal_to_file(sd.models, xl_cfg, want, "SDXL from_checkpoint")
    print(f"C2 load from_checkpoint (eager): {dt:.2f} s, {peak.text()}; {n} tensors equal "
          f"the file's, bit for bit  [{card}]", flush=True)
    with HostPeak() as peak:
        t = time.perf_counter()
        streamed = assemble(xl_cfg, stream.load_sd_checkpoint_streamed(ckpt, xl_cfg))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    equal_to_file(streamed, xl_cfg, want, "SDXL load_sd_checkpoint_streamed")
    print(f"C2 load load_sd_checkpoint_streamed: {dt:.2f} s, {peak.text()}; every tensor "
          f"equal, bit for bit  [{card}]", flush=True)
    del streamed, want
    os.remove(ckpt)
    files_kw = dict(steps=8)
    # the bundles' requests: their own tokenizer (textual inversion's
    # placeholders), 8 steps
    bkw = {k: v for k, v in base.items() if k not in ("tokenizer", "device")}
    bkw["n_inference_steps"] = 8
    f_base, _ = run("g from_checkpoint bundle, 8 steps", lambda: sd.txt2img(PROMPTS[0], **bkw),
                    "sdxl", **files_kw)
    lora_path = os.path.join(d, "lora.safetensors")
    factors = lora_file(sd.models, xl_cfg, lora_path,
                        torch.Generator(device="cuda").manual_seed(25))
    roots = sorted({dotted.split(".")[0] for dotted in lora._weight_targets(xl_cfg)})
    sd_lora = sd.with_lora(lora_path)
    changed = [m for m in sd.models if sd_lora.models[m] is not sd.models[m]]
    check(changed == ["clip", "clip2", "diffusion"], f"SDXL LoRA changed {changed}")
    lora_img, _ = run("h with_lora (kohya: lora_te1_, lora_te2_, lora_unet_)", lambda:
                      sd_lora.txt2img(PROMPTS[0], **bkw), "sdxl", **files_kw)
    zero_img, _ = run("i with_lora(scale=0)", lambda: sd.with_lora(lora_path, scale=0.0)
                      .txt2img(PROMPTS[0], **bkw), "sdxl", **files_kw)
    check(not np.array_equal(lora_img, f_base), "SDXL with_lora: the image did not change")
    check(np.array_equal(zero_img, f_base), "SDXL with_lora(scale=0): not bit-identical")
    print(f"C2 LoRA: {len(factors)} targets over {roots}; scale 0 bit-identical to the base",
          flush=True)
    del sd_lora
    g = torch.Generator().manual_seed(26)
    emb = {"clip_l": torch.randn(2, 768, generator=g) * 0.4,
           "clip_g": torch.randn(2, 1280, generator=g) * 0.4}
    sd_ti = sd.with_textual_inversion(emb, token="xl-toy")
    ti_prompt = "a photograph of xl-toy riding a horse"
    check(sum(i >= 49408 for i in sd_ti.tokenizer.encode(ti_prompt)) == 2,
          "SDXL textual inversion: token ids")
    ti_img, _ = run("j with_textual_inversion (dual-tower, trigger in the prompt)", lambda:
                    sd_ti.txt2img(ti_prompt, **bkw), "sdxl", config=sd_ti.config, **files_kw)
    check(not np.array_equal(ti_img, f_base), "SDXL textual inversion: the same image")
    del sd_ti, sd
    tmp.cleanup()
    torch.cuda.empty_cache()
    return xl, xl_cfg


# ------------------------------------------------------------------ slice C3
def c3_variant(port, models, cfg, preset, seed):
    """The models of ``preset`` (a slice-C3 preset of ``cfg``'s family, on
    ``cfg``'s policy and backends) around ``models``' tensors: every UNet
    tensor the preset shares with the family's is the same tensor; those it
    changes or adds (a 9- or 8-channel conv_in weight, LCM's cond_proj) are
    drawn U(-1/sqrt(fan in), 1/sqrt(fan in)) from ``seed`` on the models'
    device, as the port's initializers draw them."""
    import math

    from pytorch_stable_diffusion_tpu_torch.models import assemble, construct

    new = dataclasses.replace(
        getattr(port, preset)(policy=cfg.policy), attention_backend=cfg.attention_backend,
        vae_attention_backend=cfg.vae_attention_backend, conv_backend=cfg.conv_backend)
    sd = dict(models["diffusion"].state_dict())
    dev = next(iter(sd.values())).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for k, v in construct(new)["diffusion"].state_dict().items():
        if k not in sd or sd[k].shape != v.shape:
            check("conv_in" in k or "cond_proj" in k, f"{preset}: {k} differs from the base")
            bound = 1.0 / math.sqrt(math.prod(v.shape[1:]))
            sd[k] = ((torch.rand(v.shape, generator=g, device=dev) * 2 - 1) * bound) \
                .to(cfg.policy.param_dtype)
    return new, dict(models, diffusion=assemble(new, {"diffusion": sd})["diffusion"])


def _c3_mask(height, width, box):
    import numpy as np

    y0, y1, x0, x1 = box
    m = np.zeros((height, width), np.float32)
    m[y0:y1, x0:x1] = 1.0
    return m


def seeded_cpu_models(port, cfg, seed):
    """``cfg``'s models on the CPU with weights drawn from ``seed`` on the card
    (its generator is many times faster than the host's) and copied over:
    the CPU side of the small checks."""
    gpu = port.build_models(cfg, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed))
    sds = {k: {n: t.cpu() for n, t in m.state_dict().items()} for k, m in gpu.items()}
    del gpu
    torch.cuda.empty_cache()
    return port.build_models(cfg, device="cpu", state_dicts=sds)


def small_sd15_cpu(port):
    """SD-1.5 at full width in FP32 on the CPU, from a seed: the CPU side of
    the ``small C3`` and ``small E`` checks."""
    t0 = time.perf_counter()
    base = port.sd15_config(policy=port.FP32)
    with HostPeak() as peak:
        cpu = seeded_cpu_models(port, base, 31)
    print(f"small C3/E: SD-1.5 FP32 built for the CPU in {time.perf_counter() - t0:.1f} s, "
          f"{peak.text()}", flush=True)
    return cpu, base


def free_host():
    import ctypes
    import gc

    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def phase_small_c3(port, cpu, base):
    """Full width, FP32, 256², 2 steps, CFG 5, the card against the port's
    CPU plain path on the same seeded weights and noise (> 55 dB latents,
    > 40 dB image, the launches of the plan): SD-1.5 9-channel inpainting
    (unet9), latent-blend inpainting on the 4-channel model, InstructPix2Pix
    (three lanes) and LCM without CFG (one lane, the guidance embedding).
    The variants share SD-1.5's CPU tensors (``cpu``, :func:`c3_variant`);
    each is copied to the card in turn."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm

    tok = _tokenizer()
    r = np.random.RandomState(33)
    image = r.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    mask = _c3_mask(256, 256, (64, 160, 96, 224))
    kw = dict(uncond_prompt="a dog", cfg_scale=5.0, seed=17, height=256, width=256,
              tokenizer=tok, return_latents=True, n_inference_steps=2)
    kernels = dict(attention_backend="kernel", vae_attention_backend="kernel")
    requests = (  # label, preset, options, VAE encodes
        ("unet9 inpaint", "sd15_inpaint_config",
         dict(input_image=image, mask_image=mask, strength=1.0, sampler_name="ddpm"), 2),
        ("blend inpaint", "sd15_config",
         dict(input_image=image, mask_image=mask, strength=0.5, mask_blur=4,
              sampler_name="euler_a"), 1),
        ("InstructPix2Pix", "sd15_ip2p_config",
         dict(edit_image=image, image_guidance_scale=1.5, sampler_name="euler_a"), 1),
        ("LCM, no CFG", "sd15_lcm_config", dict(do_cfg=False, sampler_name="lcm"), 0))
    for i, (label, preset, opts, encodes) in enumerate(requests):
        t1 = time.perf_counter()
        cfg_c, cpu_m = c3_variant(port, cpu, base, preset, seed=60 + i)
        img_c, lat_c = port.generate(PROMPTS[0], models=cpu_m, config=cfg_c, device="cpu",
                                     **kw, **opts)
        t_cpu = time.perf_counter() - t1
        cfg_g = dataclasses.replace(cfg_c, **kernels)
        gpu_m = port.build_models(cfg_g, device="cuda",
                                  state_dicts={k: m.state_dict() for k, m in cpu_m.items()})
        evals = 2 - ddpm.start_step_for_strength(2, opts.get("strength", 1.0)) \
            if "input_image" in opts else 2
        want = expected_launches(cfg_g, 256, 256, steps=evals, img2img=False, encodes=encodes)
        before = launch_counts()
        img_g, lat_g = port.generate(PROMPTS[0], models=gpu_m, config=cfg_g, device="cuda",
                                     **kw, **opts)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in launch_counts().items()}
        lat_db = psnr(lat_c, lat_g)
        img_db = psnr(img_c.astype(np.float32), img_g.astype(np.float32))
        print(f"small C3 ({label}): full-width FP32 256², {evals} UNet evaluations, CFG 5, "
              f"card vs CPU plain path: latents PSNR {lat_db:.1f} dB, image PSNR "
              f"{img_db:.1f} dB, launches {got}; CPU side {t_cpu:.1f} s", flush=True)
        check(got == want, f"small C3 ({label}) launched {got}, want {want}")
        check(np.isfinite(lat_g).all(), f"small C3 ({label}): latents not finite")
        check(lat_db > 55.0, f"small C3 ({label}) latents PSNR {lat_db:.1f} dB <= 55")
        check(img_db > 40.0, f"small C3 ({label}) image PSNR {img_db:.1f} dB <= 40")
        del cpu_m, gpu_m
        torch.cuda.empty_cache()


def c3_run(label, fn, parts, shape, card, zero_counts, read_path, slice_name="C3"):
    """One slice-C3 (or ``slice_name``) request: the launch counters zeroed
    before it and read after; its launches held to the plan of its
    ``parts`` (each a generate() call: (config, height, width, UNet
    evaluations, VAE encodes, context tokens[, slice E's
    :func:`expected_launches` options: controlnets, reference])); its
    output's shape; its wall time and peak memory."""
    import numpy as np

    label = f"{slice_name} {label}"
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launched = launch_counts()
    read_path()
    want = {k: 0 for k in launched}
    evals = 0
    for cfg, height, width, n, encodes, context, *side in parts:
        evals += n
        plain = expected_launches(cfg, height, width, steps=n, img2img=False, encodes=encodes,
                                  context=context)
        family = "sdxl" if cfg.clip2 is not None else None
        stated = C2_PER_EVAL[family] if family else {"K5": K5_PER_EVAL, "K2": K2_PER_EVAL}
        check(plain["K5"] == stated["K5"] * n, f"{label}: derived {plain['K5']} K5 launches, "
                                               f"PERF.md states {stated['K5'] * n}")
        check(plain["K2"] == (stated["K2"] * n if context >= 256 else 0),
              f"{label}: derived {plain['K2']} K2 launches")
        per = expected_launches(cfg, height, width, steps=n, img2img=False, encodes=encodes,
                                context=context, **(side[0] if side else {}))
        for k, v in per.items():
            want[k] += v
    images = out[0] if isinstance(out, tuple) else out
    check(images.dtype == np.uint8 and images.shape == shape,
          f"{label}: output {images.dtype} {images.shape}, want {shape}")
    check(images.max() > images.min(), f"{label}: constant image")
    if isinstance(out, tuple):
        check(np.isfinite(out[1]).all(), f"{label}: latents not finite")
    check(launched == want, f"{label}: launched {launched}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"request {label}: {dt:.2f} s wall, {evals} UNet evaluations, output "
          f"{shape[1]}x{shape[0]}, launches {launched}, peak {peak:.2f} GiB  [{card}]",
          flush=True)
    return out


def phase_slice_c3(port, card, models, cfg, zero_counts, read_path):
    """Slice C3 at SD-1.5 512², full width, BF16, kernel attention, conv and
    VAE (the module docstring, phase 6, slice C3); the inpaint, InstructPix2Pix
    and LCM UNets are the phase-5 models' with their conv_in or cond_proj
    drawn (:func:`c3_variant`); one InstructPix2Pix and one no-CFG LCM
    evaluation profiled as in phase 7."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch import pipeline
    from pytorch_stable_diffusion_tpu_torch.core import rng
    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm
    from pytorch_stable_diffusion_tpu_torch.utils.annotators import blur

    base_cfg = dataclasses.replace(cfg, conv_backend="kernel", vae_attention_backend="kernel")
    inp_cfg, inp = c3_variant(port, models, base_cfg, "sd15_inpaint_config", seed=41)
    ip_cfg, ip = c3_variant(port, models, base_cfg, "sd15_ip2p_config", seed=42)
    lcm_cfg, lcm = c3_variant(port, models, base_cfg, "sd15_lcm_config", seed=43)
    tok = _tokenizer()
    r = np.random.RandomState(34)
    image = r.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    half = _c3_mask(512, 512, (0, 512, 256, 512))  # the right half
    kw = dict(uncond_prompt="", cfg_scale=7.5, seed=1337, tokenizer=tok, device="cuda",
              sampler_name="dpm++", timestep_spacing="karras", n_inference_steps=10)

    def run(label, fn, parts, shape):
        return c3_run(label, fn, parts, shape, card, zero_counts, read_path)

    def gen(models_, cfg_, **more):
        return lambda: port.generate(PROMPTS[0], models=models_, config=cfg_,
                                     return_latents=True, **{**kw, **more})

    sq = (512, 512, 3)
    a, lat_a = run("a unet9 inpaint 512², dpm++ karras 10 steps, half mask, strength 1.0",
                   gen(inp, inp_cfg, input_image=image, mask_image=half, strength=1.0),
                   [(inp_cfg, 512, 512, 10, 2, 77)], sq)
    a2, lat_a2 = run("a' the same again", gen(inp, inp_cfg, input_image=image, mask_image=half,
                                             strength=1.0),
                     [(inp_cfg, 512, 512, 10, 2, 77)], sq)
    check(np.array_equal(a, a2) and np.array_equal(lat_a, lat_a2),
          "C3 unet9 inpaint: the same seed gave a different result")
    kept = a[:, :256].astype(np.float32)
    print(f"C3 a: a' == a bit-identical; kept half vs the init image PSNR "
          f"{psnr(kept, image[:, :256].astype(np.float32)):.1f} dB (not gated)", flush=True)

    # (b) latent blend on the 4-channel model: the kept latents are the init's
    mask_b = _c3_mask(512, 512, (128, 384, 192, 448))
    start = ddpm.start_step_for_strength(10, 0.75)
    pixels = torch.as_tensor(pipeline._prepare_image(image, 512, 512)).cuda()
    pixels = pixels.contiguous(memory_format=torch.channels_last if pixels.is_cuda
                               else torch.contiguous_format)  # the pipeline's layout
    with torch.inference_mode():
        lat0 = pipeline.encode_image(
            models, pixels, rng.batch_normal(1337, "encoder_noise", 1, (4, 64, 64)).cuda(),
            base_cfg).float().cpu().numpy()
    blurred = np.clip(blur(pipeline._prepare_mask(mask_b, 512, 512)[0, ..., 0], sigma=4.0),
                      0.0, 1.0)[None, ..., None].astype(np.float32)
    keep = pipeline.mask_to_latent_area(blurred, 8)[0, ..., 0] == 0
    for sampler, evals in (("euler_a", 10 - start), ("heun", 2 * (10 - start) - 1)):
        _, lat_b = run(f"b blend inpaint, {sampler}, strength 0.75, mask_blur=4",
                       gen(models, base_cfg, input_image=image, mask_image=mask_b,
                           strength=0.75, mask_blur=4, sampler_name=sampler,
                           timestep_spacing="uniform"),
                       [(base_cfg, 512, 512, evals, 1, 77)], sq)
        check(np.array_equal(lat_b[:, :, keep], lat0[:, :, keep]),
              f"C3 b ({sampler}): the kept latents differ from the init image's")
        print(f"C3 b ({sampler}): {int(keep.sum())} of {keep.size} latent pixels kept, each "
              f"equal to the init image's encoded latents", flush=True)

    # (c) inpaint at full resolution: a 96x96 mask in a 768x512 image
    wide = r.randint(0, 256, (512, 768, 3)).astype(np.uint8)
    box = (200, 296, 300, 396)
    sd_inp = port.StableDiffusion(inp, tok, inp_cfg, device="cuda")
    full = run("c inpaint(full_res=True), a 96x96 mask in a 768x512 image",
               lambda: sd_inp.inpaint(PROMPTS[0], wide, _c3_mask(512, 768, box), full_res=True,
                                      **{k: v for k, v in kw.items() if k != "tokenizer"}),
               [(inp_cfg, 512, 512, 10, 2, 77)], (512, 768, 3))
    pad = 32  # full_res_padding: a 160x160 crop, square as the 512² processing size
    crop = np.zeros((512, 768), bool)
    crop[box[0] - pad:box[1] + pad, box[2] - pad:box[3] + pad] = True
    check(np.array_equal(full[~crop], wide[~crop]),
          "C3 c: pixels outside the crop differ from the input")
    check(not np.array_equal(full[crop], wide[crop]), "C3 c: the crop did not change")
    print(f"C3 c: {int((~crop).sum())} pixels outside the crop equal to the input's",
          flush=True)

    # (d) masked_content="fill" on the 4-channel model; (e) outpaint on unet9
    sd_base = port.StableDiffusion(models, tok, base_cfg, device="cuda")
    skw = {k: v for k, v in kw.items() if k != "tokenizer"}
    run("d inpaint(masked_content='fill'), blend, strength 0.75",
        lambda: sd_base.inpaint(PROMPTS[0], image, mask_b, strength=0.75,
                                masked_content="fill", height=512, width=512, **skw),
        [(base_cfg, 512, 512, 10 - start, 1, 77)], sq)
    out_e = run("e outpaint 64 px left and right (640x512 canvas), unet9",
                lambda: sd_inp.outpaint(PROMPTS[0], image, pixels=64,
                                        directions=("left", "right"), **skw),
                [(inp_cfg, 512, 640, 10, 2, 77)], (512, 640, 3))
    check(out_e.shape == (512, 640, 3), "C3 e: canvas shape")
    start_f = ddpm.start_step_for_strength(10, 0.6)
    f_img, _ = run("f img2img strength 0.6 with color_correction",
                   gen(models, base_cfg, input_image=image, strength=0.6,
                       color_correction=True),
                   [(base_cfg, 512, 512, 10 - start_f, 1, 77)], sq)

    # (g) InstructPix2Pix: three lanes; with a 4-window prompt K2 at lane count 3
    sd_ip = port.StableDiffusion(ip, tok, ip_cfg, device="cuda")
    ekw = dict(skw, sampler_name="euler_a", timestep_spacing="uniform")
    run("g edit, euler_a 10 steps, CFG 7.5, image guidance 1.5",
        lambda: sd_ip.edit(PROMPTS[0], image, image_guidance_scale=1.5, **ekw),
        [(ip_cfg, 512, 512, 10, 1, 77)], sq)
    run("g' edit with the 4-window prompt (K2 at lane count 3)",
        lambda: sd_ip.edit(LONG_PROMPT, image, image_guidance_scale=1.5, emphasis=True,
                           **ekw),
        [(ip_cfg, 512, 512, 10, 1, 308)], sq)

    # (h) LCM, 4 steps, no CFG: one lane and the guidance embedding
    run("h LCM 4 steps, do_cfg=False", gen(lcm, lcm_cfg, do_cfg=False, sampler_name="lcm",
                                          timestep_spacing="uniform", n_inference_steps=4),
        [(lcm_cfg, 512, 512, 4, 0, 77)], sq)

    # (i) hires_fix 512² -> 1024², strength 0.6
    start_i = ddpm.start_step_for_strength(10, 0.6)
    for method in ("bilinear", "lanczos3"):
        run(f"i hires_fix 512² -> 1024², strength 0.6, {method}",
            lambda: sd_base.hires_fix(PROMPTS[0], height=1024, width=1024, strength=0.6,
                                      upscale_method=method, **skw),
            [(base_cfg, 512, 512, 10, 0, 77), (base_cfg, 1024, 1024, 10 - start_i, 0, 77)],
            (1024, 1024, 3))

    # one evaluation of each new lane count, profiled
    phase_step(ip, ip_cfg, card, size=512, batch=3, label="SD-1.5 InstructPix2Pix")
    phase_step(lcm, lcm_cfg, card, size=512, batch=1, label="SD-1.5 LCM, no CFG")
    del inp, ip, lcm, sd_inp, sd_ip, sd_base
    torch.cuda.empty_cache()


def phase_slice_c3_xl(port, card, xl, xl_cfg, zero_counts, read_path):
    """Slice C3 on SDXL 1024² (after slice C2, the SD-1.5 models freed):
    (j) unet9 inpainting, 10 dpm++ Karras steps, and (k) LCM, 4 steps,
    without CFG; the UNets are C2's SDXL base with its conv_in or cond_proj
    drawn (:func:`c3_variant`)."""
    import numpy as np

    inp_cfg, inp = c3_variant(port, xl, xl_cfg, "sdxl_inpaint_config", seed=44)
    lcm_cfg, lcm = c3_variant(port, xl, xl_cfg, "sdxl_lcm_config", seed=45)
    r = np.random.RandomState(35)
    image = r.randint(0, 256, (1024, 1024, 3)).astype(np.uint8)
    kw = dict(uncond_prompt="", cfg_scale=5.0, seed=1337, tokenizer=_tokenizer(),
              device="cuda", height=1024, width=1024, return_latents=True,
              sampler_name="dpm++", timestep_spacing="karras", n_inference_steps=10)
    c3_run("j SDXL unet9 inpaint 1024², dpm++ karras 10 steps, strength 1.0",
           lambda: port.generate(PROMPTS[0], models=inp, config=inp_cfg, input_image=image,
                                 mask_image=_c3_mask(1024, 1024, (256, 768, 256, 768)),
                                 strength=1.0, **kw),
           [(inp_cfg, 1024, 1024, 10, 2, 77)], (1024, 1024, 3), card, zero_counts, read_path)
    c3_run("k SDXL LCM 1024², 4 steps, do_cfg=False",
           lambda: port.generate(PROMPTS[0], models=lcm, config=lcm_cfg, do_cfg=False,
                                 **{**kw, "sampler_name": "lcm", "timestep_spacing": "uniform",
                                    "n_inference_steps": 4, "cfg_scale": 8.0}),
           [(lcm_cfg, 1024, 1024, 4, 0, 77)], (1024, 1024, 3), card, zero_counts, read_path)
    phase_step(lcm, lcm_cfg, card, size=1024, batch=1, label="SDXL LCM, no CFG")
    del inp, lcm
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ slice E
def ip_adapter_state(ucfg, vis, *, plus, seed):
    """An IP-Adapter state dict of the published layout for ``ucfg``'s UNet
    and the tower ``vis``, its weights drawn from ``seed`` at a layer's
    usual scale (1/sqrt(fan in); norms near 1): the standard adapter (4
    tokens from the projected embedding) or "plus" (the perceiver
    Resampler over the penultimate hidden states: 16 queries of width 768,
    4 layers of 12 heads of 64, as the published ViT-H plus adapters)."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.weights import ip_adapter

    r = np.random.RandomState(seed)

    def lin(o, i):
        return (r.randn(o, i) / np.sqrt(i)).astype(np.float32)

    def ln(n):
        return (1 + 0.1 * r.randn(n)).astype(np.float32), (0.1 * r.randn(n)).astype(np.float32)

    state = ip_adapter.synthetic_ip_state(ucfg, n_tok=4, embed_dim=vis.proj_dim, seed=seed)
    for group in state.values():
        for k, v in group.items():
            group[k] = v / np.sqrt(v.shape[1]) if v.ndim == 2 else v
    d_ctx = ucfg.d_context
    if plus:
        dim, inner = 768, 768
        proj = {"latents": r.randn(1, 16, dim).astype(np.float32) / np.sqrt(dim),
                "proj_in.weight": lin(dim, vis.width), "proj_in.bias": ln(dim)[1],
                "proj_out.weight": lin(d_ctx, dim), "proj_out.bias": ln(d_ctx)[1]}
        proj["norm_out.weight"], proj["norm_out.bias"] = ln(d_ctx)
        for i in range(4):
            for name in ("0.norm1", "0.norm2", "1.0"):
                proj[f"layers.{i}.{name}.weight"], proj[f"layers.{i}.{name}.bias"] = ln(dim)
            proj.update({f"layers.{i}.0.to_q.weight": lin(inner, dim),
                         f"layers.{i}.0.to_kv.weight": lin(2 * inner, dim),
                         f"layers.{i}.0.to_out.weight": lin(dim, inner),
                         f"layers.{i}.1.1.weight": lin(4 * dim, dim),
                         f"layers.{i}.1.3.weight": lin(dim, 4 * dim)})
        state["image_proj"] = proj
    return state


def side_nets(port, cfg, device, seed, *, nets=2, vision=True):
    """Slice E's side nets for ``cfg`` on ``device``, every weight drawn from
    ``seed`` (the ControlNets' zero convs and mid_out too, so that their
    residuals are not zero): ``nets`` ControlNets, a T2I-Adapter and, with
    ``vision``, the ViT-H/14 tower and a standard and a "plus" IP-Adapter."""
    from pytorch_stable_diffusion_tpu_torch.models import clip_vision as cv
    from pytorch_stable_diffusion_tpu_torch.models import controlnet, t2i_adapter
    from pytorch_stable_diffusion_tpu_torch.weights import ip_adapter

    def g(k):
        return torch.Generator(device=device).manual_seed(seed + k)

    out = {"controlnet": [controlnet.build(cfg, device=device, generator=g(k))
                          for k in range(nets)],
           "t2i_adapter": t2i_adapter.build(cfg, device=device, generator=g(2))}
    if vision:
        vis, dtype = cv.vit_h14(), cfg.policy.param_dtype
        out["clip_vision"] = cv.build_clip_vision(vis, dtype=dtype, device=device,
                                                  generator=g(3))
        for name, plus in (("ip_adapter", False), ("ip_plus", True)):
            sd = ip_adapter.convert_ip_adapter(
                ip_adapter_state(cfg.unet, vis, plus=plus, seed=seed + 4 + plus), cfg.unet)
            out[name] = cv.build_ip_adapter(sd, dtype=dtype, device=device)
    return out


def on_card(cfg, side):
    """``side`` (:func:`side_nets` on the CPU) copied to the card in ``cfg``'s
    dtype."""
    from pytorch_stable_diffusion_tpu_torch.models import clip_vision as cv
    from pytorch_stable_diffusion_tpu_torch.models import controlnet, t2i_adapter

    dtype = cfg.policy.param_dtype
    out = {"controlnet": [controlnet.build(cfg, device="cuda", state_dict=n.state_dict())
                          for n in side["controlnet"]],
           "t2i_adapter": t2i_adapter.build(cfg, device="cuda",
                                            state_dict=side["t2i_adapter"].state_dict())}
    if "clip_vision" in side:
        out["clip_vision"] = cv.build_clip_vision(side["clip_vision"].cfg, dtype=dtype,
                                                  device="cuda",
                                                  state_dict=side["clip_vision"].state_dict())
        for name in ("ip_adapter", "ip_plus"):
            out[name] = cv.build_ip_adapter(side[name].state_dict(), dtype=dtype, device="cuda")
    return out


def with_side(models, side, *, nets=0, adapter=False, ip=None):
    """The models dict of a request: ``nets`` ControlNets (one is passed as
    a module, two as a list), the T2I-Adapter, the tower and the standard
    or the "plus" IP-Adapter (``ip``)."""
    out = dict(models)
    if nets:
        out["controlnet"] = side["controlnet"][0] if nets == 1 else side["controlnet"][:nets]
    if adapter:
        out["t2i_adapter"] = side["t2i_adapter"]
    if ip:
        out["clip_vision"] = side["clip_vision"]
        out["ip_adapter"] = side["ip_plus" if ip == "plus" else "ip_adapter"]
    return out


def hint_image(size, seed):
    """A ControlNet / T2I-Adapter hint as users make one: the Canny edges
    (``utils/annotators.canny``) of a seeded image of 64 x 64 px blocks."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.utils import annotators

    blocks = np.random.RandomState(seed).randint(0, 256, (size // 64, size // 64, 3))
    image = np.kron(blocks, np.ones((64, 64, 1))).astype(np.uint8)
    return annotators.hint_rgb(annotators.canny(image))


def phase_small_e(port, cpu, base):
    """Slice E at full width, FP32, 256², 2 steps, CFG 5: the card against
    the port's CPU plain path on the same seeded weights and noise (> 55 dB
    latents, > 40 dB image, the plan's launches): a ControlNet, two, the
    T2I-Adapter, IP-Adapter standard and plus (the ViT-H/14 tower at 224²),
    reference ``attn`` and ``adain``.  The side nets are drawn on the CPU
    and copied to the card."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.models import clip_vision as cv

    tok = _tokenizer()
    r = np.random.RandomState(36)
    kw = dict(uncond_prompt="a dog", cfg_scale=5.0, seed=17, height=256, width=256,
              tokenizer=tok, return_latents=True, n_inference_steps=1, sampler_name="euler_a")
    t0 = time.perf_counter()
    with HostPeak() as peak:
        # drawn on the card (its generator is many times faster than the
        # host's) and copied to the CPU in its layout
        side = {k: [n.to("cpu", memory_format=torch.contiguous_format) for n in v]
                if isinstance(v, list) else v.to("cpu", memory_format=torch.contiguous_format)
                for k, v in side_nets(port, base, "cuda", 80).items()}
        torch.cuda.empty_cache()
    print(f"small E: side nets FP32 built for the CPU in {time.perf_counter() - t0:.1f} s, "
          f"{peak.text()}", flush=True)
    ip_image = r.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    hint = hint_image(256, 37)
    requests = (  # label, side nets, options, launch-plan options
        ("ControlNet", dict(nets=1), dict(control_image=hint), dict(controlnets=1)),
        ("two ControlNets", dict(nets=2),
         dict(control_image=[hint, hint_image(256, 38)], controlnet_scale=[1.0, 0.5]),
         dict(controlnets=2)),
        ("T2I-Adapter", dict(adapter=True), dict(adapter_image=hint), {}),
        ("IP-Adapter", dict(ip="standard"), dict(ip_adapter_image=ip_image), {}),
        ("IP-Adapter plus", dict(ip="plus"), dict(ip_adapter_image=ip_image), {}),
        ("reference attn", {}, dict(reference_image=r.randint(0, 256, (256, 256, 3))
                                    .astype(np.uint8), reference_fidelity=0.5),
         dict(reference="attn")),
        ("reference adain", {}, dict(reference_image=r.randint(0, 256, (256, 256, 3))
                                     .astype(np.uint8), reference_mode="adain"),
         dict(reference="adain")))
    cfg_g = dataclasses.replace(base, attention_backend="kernel", vae_attention_backend="kernel")
    gpu = port.build_models(cfg_g, device="cuda",
                            state_dicts={k: m.state_dict() for k, m in cpu.items()})
    side_g = on_card(cfg_g, side)
    for label, pick, opts, plan in requests:
        t1 = time.perf_counter()
        img_c, lat_c = port.generate(PROMPTS[0], models=with_side(cpu, side, **pick),
                                     config=base, device="cpu", clip_vision_config=cv.vit_h14(),
                                     **kw, **opts)
        t_cpu = time.perf_counter() - t1
        want = expected_launches(cfg_g, 256, 256, steps=1, img2img=False, **plan)
        before = launch_counts()
        img_g, lat_g = port.generate(PROMPTS[0], models=with_side(gpu, side_g, **pick),
                                     config=cfg_g, device="cuda", **kw, **opts)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in launch_counts().items()}
        lat_db = psnr(lat_c, lat_g)
        img_db = psnr(img_c.astype(np.float32), img_g.astype(np.float32))
        print(f"small E ({label}): full-width FP32 256², 1 euler_a step, CFG 5, card vs CPU "
              f"plain path: latents PSNR {lat_db:.1f} dB, image PSNR {img_db:.1f} dB, launches "
              f"{got}; CPU side {t_cpu:.1f} s", flush=True)
        check(got == want, f"small E ({label}) launched {got}, want {want}")
        check(np.isfinite(lat_g).all(), f"small E ({label}): latents not finite")
        check(lat_db > 55.0, f"small E ({label}) latents PSNR {lat_db:.1f} dB <= 55")
        check(img_db > 40.0, f"small E ({label}) image PSNR {img_db:.1f} dB <= 40")
    del side, side_g, gpu
    torch.cuda.empty_cache()
    free_host()


def phase_slice_e(port, card, models, cfg, zero_counts, read_path):
    """Slice E at SD-1.5 512², full width, BF16, attention, conv and VAE on
    the kernels, dpm++ Karras 10 steps, CFG 7.5, seed 1337, on the phase-5
    models with side nets drawn from a seed (:func:`side_nets`): (a) a
    ControlNet on a Canny hint, (a') again, bit-identical, (a'') at scale 0,
    bit-identical to the request without it; (b) two ControlNets at [1.0,
    0.5]; (c) the T2I-Adapter (full_adapter); (d) IP-Adapter with ViT-H/14,
    4 tokens, and (d') plus, 16 tokens; (e) reference-only in each mode at
    fidelity 0.5, and (e') attn at 768², 4 steps (K4); (f) a ControlNet with
    an IP-Adapter.  One ControlNet evaluation and one reference evaluation
    are profiled."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.models import clip_vision as cv

    base_cfg = dataclasses.replace(cfg, conv_backend="kernel", vae_attention_backend="kernel")
    t0 = time.perf_counter()
    side = side_nets(port, base_cfg, "cuda", 90)
    torch.cuda.synchronize()
    sizes = {k: sum(p.numel() for p in (v[0] if isinstance(v, list) else v).parameters())
             for k, v in side.items()}
    print(f"E: side nets BF16 built on the card in {time.perf_counter() - t0:.1f} s, "
          f"parameters {sizes}", flush=True)
    tok = _tokenizer()
    r = np.random.RandomState(39)
    hint = hint_image(512, 40)
    ip_image = r.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    ref_image = r.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    kw = dict(uncond_prompt="", cfg_scale=7.5, seed=1337, tokenizer=tok, device="cuda",
              sampler_name="dpm++", timestep_spacing="karras", n_inference_steps=10,
              return_latents=True, clip_vision_config=cv.vit_h14())
    sq = (512, 512, 3)

    def run(label, pick, parts, shape=sq, **more):
        return c3_run(label, lambda: port.generate(
            PROMPTS[0], models=with_side(models, side, **pick), config=base_cfg,
            **{**kw, **more}), parts, shape, card, zero_counts, read_path, slice_name="E")

    def plan(**side_plan):
        return [(base_cfg, 512, 512, 10, 0, 77, side_plan)]

    plain = run("a0 the request without a side net", {}, plan())
    a = run("a ControlNet, Canny hint of a seeded image", dict(nets=1), plan(controlnets=1),
            control_image=hint)
    a2 = run("a' the same again", dict(nets=1), plan(controlnets=1), control_image=hint)
    check(np.array_equal(a[0], a2[0]) and np.array_equal(a[1], a2[1]),
          "E a': the same seed gave a different result")
    a0 = run("a'' controlnet_scale=0", dict(nets=1), plan(controlnets=1), control_image=hint,
             controlnet_scale=0.0)
    check(np.array_equal(a0[0], plain[0]) and np.array_equal(a0[1], plain[1]),
          "E a'': scale 0 differs from the request without a ControlNet")
    print(f"E a: a' == a and a'' == a0 bit-identical; a vs a0 PSNR "
          f"{psnr(a[0].astype(np.float32), plain[0].astype(np.float32)):.1f} dB (not gated)",
          flush=True)
    run("b two ControlNets, scales [1.0, 0.5]", dict(nets=2), plan(controlnets=2),
        control_image=[hint, hint_image(512, 41)], controlnet_scale=[1.0, 0.5])
    run("c T2I-Adapter (full_adapter)", dict(adapter=True), plan(), adapter_image=hint)
    run("d IP-Adapter, ViT-H/14, 4 tokens", dict(ip="standard"), plan(),
        ip_adapter_image=ip_image)
    run("d' IP-Adapter plus, Resampler, 16 tokens", dict(ip="plus"), plan(),
        ip_adapter_image=ip_image)
    for mode in ("attn", "adain", "adain+attn"):
        run(f"e reference {mode}, fidelity 0.5", {}, plan(reference=mode),
            reference_image=ref_image, reference_mode=mode)
    run("e' reference attn 768², 4 steps (K4 in the read)", {},
        [(base_cfg, 768, 768, 4, 0, 77, dict(reference="attn"))], shape=(768, 768, 3),
        reference_image=np.kron(ref_image[::2, ::2], np.ones((3, 3, 1), np.uint8)),
        height=768, width=768, n_inference_steps=4)
    run("f ControlNet with IP-Adapter", dict(nets=1, ip="standard"), plan(controlnets=1),
        control_image=hint, ip_adapter_image=ip_image)
    profile_side_evals(models, base_cfg, side, card, 512, "SD-1.5")
    del side
    torch.cuda.empty_cache()


def profile_side_evals(models, cfg, side, card, size, label):
    """One ControlNet evaluation (the net, then the UNet with its residuals)
    and one reference evaluation (the capture pass, then the read) at CFG
    batch 2, profiled as in phase 7."""
    g = torch.Generator(device="cuda").manual_seed(4)
    dtype = cfg.policy.compute_dtype
    lat = size // cfg.vae.downsample_factor

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    x = rand(2, 4, lat, lat).contiguous(memory_format=torch.channels_last)
    ctx = rand(2, 77, cfg.unet.d_context)
    add = None if cfg.unet.add_embed_dim is None else \
        torch.randn(2, cfg.unet.add_embed_dim, device="cuda", generator=g)
    t, one = torch.tensor(500.0, device="cuda"), torch.tensor(1.0, device="cuda")
    net = side["controlnet"][0]
    kw = dict(attention_backend=cfg.attention_backend, conv_backend=cfg.conv_backend,
              add_cond=add)
    with torch.inference_mode():
        hint = net.encode_hint(torch.rand(2, 3, size, size, device="cuda", generator=g)
                               .contiguous(memory_format=torch.channels_last), cfg.policy)

    def controlnet_eval():
        with torch.inference_mode():
            control = net(x, ctx, t, hint, cfg.policy, conditioning_scale=one, **kw)
            return models["diffusion"](x, ctx, t, cfg.policy, control=control, **kw)

    mask = torch.tensor([0.0, 1.0], device="cuda")

    def reference_eval():
        with torch.inference_mode():
            bank = {}
            models["diffusion"](x, ctx, t, cfg.policy, ref=("capture", bank), head=False, **kw)
            return models["diffusion"](x, ctx, t, cfg.policy,
                                       ref=("read", bank, one * 0.5, mask), **kw)

    profile_eval(controlnet_eval, card, f"step E {label} ({size}², batch 2): one ControlNet "
                                        "evaluation (the net, then the UNet)")
    profile_eval(reference_eval, card, f"step E {label} ({size}², batch 2): one reference "
                                       "attn evaluation (capture, then read)")


def phase_slice_e_xl(port, card, xl, xl_cfg, zero_counts, read_path):
    """Slice E on SDXL 1024² (after slice C3's SDXL requests), dpm++ Karras
    10 steps, CFG 5: (g) an SDXL ControlNet, (h) a full_adapter_xl
    T2I-Adapter, (i) reference attn; one ControlNet and one reference
    evaluation profiled."""
    import numpy as np

    t0 = time.perf_counter()
    side = side_nets(port, xl_cfg, "cuda", 95, nets=1, vision=False)
    torch.cuda.synchronize()
    print(f"E: SDXL ControlNet and full_adapter_xl built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    hint = hint_image(1024, 42)
    kw = dict(uncond_prompt="", cfg_scale=5.0, seed=1337, tokenizer=_tokenizer(),
              device="cuda", height=1024, width=1024, return_latents=True,
              sampler_name="dpm++", timestep_spacing="karras", n_inference_steps=10)

    def run(label, pick, side_plan, **more):
        return c3_run(label, lambda: port.generate(
            PROMPTS[0], models=with_side(xl, side, **pick), config=xl_cfg, **{**kw, **more}),
            [(xl_cfg, 1024, 1024, 10, 0, 77, side_plan)], (1024, 1024, 3), card, zero_counts,
            read_path, slice_name="E")

    run("g SDXL ControlNet 1024²", dict(nets=1), dict(controlnets=1), control_image=hint)
    run("h SDXL T2I-Adapter (full_adapter_xl) 1024²", dict(adapter=True), {},
        adapter_image=hint)
    run("i SDXL reference attn 1024², fidelity 0.5", {}, dict(reference="attn"),
        reference_image=np.random.RandomState(43).randint(0, 256, (1024, 1024, 3))
        .astype(np.uint8))
    profile_side_evals(xl, xl_cfg, side, card, 1024, "SDXL")
    del side
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ slice F
#: composable prompt of slice F's AND requests: two parts, the second at 0.8
AND_PROMPT = f"{PROMPTS[0]} AND {PROMPTS[2]}:0.8"


def halves(size):
    """Left and right half-canvas region masks (H, W) in [0, 1]."""
    import numpy as np

    left = np.zeros((size, size), np.float32)
    left[:, :size // 2] = 1.0
    return [left, 1.0 - left]


@contextlib.contextmanager
def k1_calls():
    """The q shapes (B, S, C) of the K1 calls made inside the block (a
    wrapper around the attention module's binding of the K1 wrapper, which
    still counts its launches)."""
    from pytorch_stable_diffusion_tpu_torch.ops import attention

    real, shapes = attention.flash_attention_bsc, set()

    def recording(q, k, v, **kw):
        shapes.add(tuple(q.shape))
        return real(q, k, v, **kw)

    attention.flash_attention_bsc = recording
    try:
        yield shapes
    finally:
        attention.flash_attention_bsc = real


def phase_small_f(port, cpu, base):
    """Slice F at full width, FP32, 256², 1 dpm++ step (DeepCache 2), CFG 5: the card
    (kernel attention, conv and VAE) against the port's CPU plain path on
    the same seeded weights and noise (> 55 dB latents, > 40 dB image, the
    plan's launches): guidance rescale 0.7 with dynamic thresholding 0.995,
    PAG, SAG, AND with two region masks, a variation seed with the noise
    multiplier, DeepCache 2, Hypertile and ToMe at ``min_tokens=1024`` (tile
    16; level 1's 1024 tokens are under the 4096 default: the K1 shapes show
    that they engaged), FreeU, and tiling (no K5)."""
    import numpy as np

    tok = _tokenizer()
    kw = dict(uncond_prompt="a dog", cfg_scale=5.0, seed=17, height=256, width=256,
              tokenizer=tok, return_latents=True, sampler_name="dpm++")
    cfg_g = dataclasses.replace(base, attention_backend="kernel", vae_attention_backend="kernel",
                                conv_backend="kernel")
    gpu = port.build_models(cfg_g, device="cuda",
                            state_dicts={k: m.state_dict() for k, m in cpu.items()})
    ht = port.with_hypertile(cfg_g, 16, min_tokens=1024)
    tome = port.with_tome(cfg_g, 0.5, min_tokens=1024)
    requests = (  # label, card config, options, launch-plan options
        ("guidance rescale 0.7, dynamic threshold 0.995", cfg_g,
         dict(guidance_rescale=0.7, dynamic_threshold=0.995), {}),
        ("PAG 3.0", cfg_g, dict(pag_scale=3.0), dict(pag=True)),
        ("SAG 0.75", cfg_g, dict(sag_scale=0.75), dict(sag=True)),
        ("AND, two region masks", cfg_g, dict(prompt=AND_PROMPT, region_masks=halves(256)),
         {}),
        ("variation seed 0.3, noise multiplier 1.05", cfg_g,
         dict(variation_seed=18, variation_strength=0.3, noise_multiplier=1.05), {}),
        ("DeepCache 2", cfg_g, dict(deepcache=2, n_inference_steps=2),
         dict(shallow=deepcache_evals("dpm++", 2, 0, 2)[1])),
        ("Hypertile 16, 1024 tokens", ht, {}, {}),
        ("ToMe 0.5, 1024 tokens", tome, {}, {}),
        ("FreeU", cfg_g, dict(freeu=True), {}),
        ("tiling", cfg_g, dict(tiling=True), dict(tiling=True)))
    for label, cfg_r, opts, plan in requests:
        # one step each, DeepCache two (a full evaluation, then a shallow one)
        opts = dict(opts)
        prompt = opts.pop("prompt", PROMPTS[0])
        steps = opts.setdefault("n_inference_steps", 1)
        t1 = time.perf_counter()
        img_c, lat_c = port.generate(
            prompt, models=cpu, device="cpu", **kw, **opts,
            config=dataclasses.replace(cfg_r, attention_backend="plain",
                                       vae_attention_backend="plain", conv_backend="plain"))
        t_cpu = time.perf_counter() - t1
        want = expected_launches(cfg_r, 256, 256, steps=steps, img2img=False, **plan)
        before = launch_counts()
        with k1_calls() as shapes:
            img_g, lat_g = port.generate(prompt, models=gpu, config=cfg_r, device="cuda",
                                         **kw, **opts)
            torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in launch_counts().items()}
        lat_db = psnr(lat_c, lat_g)
        img_db = psnr(img_c.astype(np.float32), img_g.astype(np.float32))
        print(f"small F ({label}): full-width FP32 256², {steps} dpm++ step(s), CFG 5, card vs CPU "
              f"plain path: latents PSNR {lat_db:.1f} dB, image PSNR {img_db:.1f} dB, launches "
              f"{got}, K1 shapes {sorted(shapes)}; CPU side {t_cpu:.1f} s", flush=True)
        check(got == want, f"small F ({label}) launched {got}, want {want}")
        if cfg_r is not cfg_g:  # the tiles or the merged tokens reached K1
            planned = {key[:3] for key in plan_shapes(cfg_r, 256, 256, 2)["K1"]}
            check(shapes == planned and shapes != {key[:3] for key in plan_shapes(
                cfg_g, 256, 256, 2)["K1"]}, f"small F ({label}): K1 shapes {shapes}, "
                                           f"planned {planned}")
        check(np.isfinite(lat_g).all(), f"small F ({label}): latents not finite")
        check(lat_db > 55.0, f"small F ({label}) latents PSNR {lat_db:.1f} dB <= 55")
        check(img_db > 40.0, f"small F ({label}) image PSNR {img_db:.1f} dB <= 40")
    del gpu
    torch.cuda.empty_cache()


def seam_ratio(image):
    """Mean |difference| across the wrap seams (last column to first, last
    row to first) over the mean |difference| of interior neighbours: about
    1 for an image that tiles."""
    import numpy as np

    x = image.astype(np.float32)
    seam = np.concatenate([np.abs(x[:, -1] - x[:, 0]).ravel(),
                           np.abs(x[-1] - x[0]).ravel()]).mean()
    inner = np.concatenate([np.abs(np.diff(x, axis=1)).ravel(),
                            np.abs(np.diff(x, axis=0)).ravel()]).mean()
    return seam / inner


def phase_slice_f(port, card, models, cfg, zero_counts, read_path):
    """Slice F at SD-1.5 512², full width, BF16, kernel attention, conv and
    VAE, dpm++ Karras 10 steps, CFG 7.5, seed 1337, on the phase-5 models:
    (a) guidance rescale 0.7, (b) dynamic thresholding 0.995, (c) PAG 3.0,
    (d) SAG 0.75, (e) "... AND ...:0.8" and (e') with two half-canvas
    region masks, (f) a variation seed at 0.3 and (f') seed 1 at strength 1
    towards variation seed 2 (bit-identical to seed 2), (g) the noise
    multiplier 1.05 and (g') 1.0 (bit-identical to the request without it),
    (h) DeepCache 3 and (h') 1 (bit-identical), (i) Hypertile 32 and (i')
    64 (one tile: bit-identical), (j) ToMe 0.5 twice (bit-identical), (k)
    FreeU (the SD defaults) and (k') (1, 1, 1, 1) (bit-identical), (l)
    tiling (no K5; the seams' ratio printed and held under 1.5).  One PAG
    evaluation, one DeepCache shallow evaluation and one Hypertile
    evaluation profiled."""
    import numpy as np

    base_cfg = dataclasses.replace(cfg, conv_backend="kernel", vae_attention_backend="kernel")
    tok = _tokenizer()
    kw = dict(uncond_prompt="", cfg_scale=7.5, seed=1337, tokenizer=tok, device="cuda",
              sampler_name="dpm++", timestep_spacing="karras", n_inference_steps=10,
              return_latents=True)
    sq = (512, 512, 3)

    def run(label, config=base_cfg, prompt=PROMPTS[0], plan=None, **more):
        return c3_run(label, lambda: port.generate(prompt, models=models, config=config,
                                                   **{**kw, **more}),
                      [(config, 512, 512, 10, 0, 77, plan or {})], sq, card, zero_counts,
                      read_path, slice_name="F")

    def same(x, y, what):
        check(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]),
              f"F {what}: not bit-identical")

    def moved(x, y):
        return f"{psnr(x[0].astype(np.float32), y[0].astype(np.float32)):.1f} dB"

    plain = run("base: the request without a slice F option")
    out = {"a": run("a guidance_rescale 0.7", guidance_rescale=0.7),
           "b": run("b dynamic_threshold 0.995", dynamic_threshold=0.995),
           "c": run("c PAG 3.0", pag_scale=3.0, plan=dict(pag=True)),
           "d": run("d SAG 0.75", sag_scale=0.75, plan=dict(sag=True)),
           "e": run("e AND, weight 0.8", prompt=AND_PROMPT)}
    out["e'"] = run("e' AND with two half-canvas region masks", prompt=AND_PROMPT,
                    region_masks=halves(512))
    out["f"] = run("f variation seed 7 at 0.3", variation_seed=7, variation_strength=0.3)
    f1 = run("f' seed 1, variation seed 2 at 1.0", seed=1, variation_seed=2,
             variation_strength=1.0)
    same(f1, run("f' seed 2 without variation", seed=2), "f' (seed 2's noise)")
    out["g"] = run("g noise_multiplier 1.05", noise_multiplier=1.05)
    same(run("g' noise_multiplier 1.0", noise_multiplier=1.0), plain, "g'")
    full, shallow = deepcache_evals("dpm++", 10, 0, 3)
    out["h"] = run(f"h deepcache 3 ({full} full, {shallow} shallow)", deepcache=3,
                   plan=dict(shallow=shallow))
    same(run("h' deepcache 1", deepcache=1), plain, "h'")
    ht = port.with_hypertile(base_cfg, 32)
    out["i"] = run("i Hypertile 32", config=ht)
    same(run("i' Hypertile 64 (one tile)", config=port.with_hypertile(base_cfg, 64)),
         plain, "i'")
    out["j"] = run("j tome_ratio 0.5", tome_ratio=0.5, config=port.with_tome(base_cfg, 0.5))
    same(run("j again", tome_ratio=0.5, config=port.with_tome(base_cfg, 0.5)), out["j"],
         "j (ToMe twice)")
    out["k"] = run("k freeu=True", freeu=True)
    same(run("k' freeu=(1, 1, 1, 1)", freeu=(1.0, 1.0, 1.0, 1.0)), plain, "k'")
    out["l"] = run("l tiling", tiling=True, plan=dict(tiling=True))
    ratio, plain_ratio = seam_ratio(out["l"][0]), seam_ratio(plain[0])
    check(ratio < 1.5, f"F l: the tiled image's seams differ {ratio:.3f}x its interior")
    print(f"F: f' == seed 2, g' h' i' k' == base and j == j again, bit-identical; l: seam / "
          f"interior neighbour difference {ratio:.3f} tiled, {plain_ratio:.3f} without; "
          f"PSNR against the base (not gated): "
          + ", ".join(f"{k} {moved(v, plain)}" for k, v in out.items()), flush=True)
    profile_f_evals(models, base_cfg, ht, card)


def profile_f_evals(models, cfg, ht_cfg, card, size=512, label="SD-1.5"):
    """One PAG evaluation (CFG batch 2, then the cond lane with the mid
    block's identity map), one DeepCache shallow evaluation (batch 2, from
    a cached feature) and one Hypertile evaluation (batch 2), profiled as
    in phase 7."""
    from pytorch_stable_diffusion_tpu_torch.models import unet

    g = torch.Generator(device="cuda").manual_seed(5)
    dtype = cfg.policy.compute_dtype
    lat = size // cfg.vae.downsample_factor
    x = torch.randn(2, 4, lat, lat, device="cuda", generator=g).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    ctx = torch.randn(2, 77, cfg.unet.d_context, device="cuda", generator=g).to(dtype)
    add = None if cfg.unet.add_embed_dim is None else \
        torch.randn(2, cfg.unet.add_embed_dim, device="cuda", generator=g)
    t = torch.tensor(500.0, device="cuda")
    kw = dict(attention_backend=cfg.attention_backend, conv_backend=cfg.conv_backend)
    u = models["diffusion"]

    def pag_eval():
        with torch.inference_mode():
            u(x, ctx, t, cfg.policy, add_cond=add, **kw)
            return u(x[:1], ctx[:1], t, cfg.policy, pag=True,
                     add_cond=None if add is None else add[:1], **kw)

    with torch.inference_mode():
        cache = u(x, ctx, t, cfg.policy, add_cond=add, return_cache=True, **kw)[1]
    check(tuple(cache.shape) == unet.deepcache_shape(cfg.unet, 2, lat, lat),
          "DeepCache feature shape")

    def shallow_eval():
        with torch.inference_mode():
            return u(x, ctx, t, cfg.policy, add_cond=add, cache=cache, **kw)

    def hypertile_eval():
        with torch.inference_mode():
            return u(x, ctx, t, cfg.policy, add_cond=add, modes=ht_cfg.unet, **kw)

    where = f"step F {label} ({size}², batch 2, {cfg.conv_backend})"
    profile_eval(pag_eval, card, f"{where}: one PAG evaluation (CFG, then the cond lane)")
    profile_eval(shallow_eval, card, f"{where}: one DeepCache shallow evaluation")
    profile_eval(hypertile_eval, card, f"{where}: one Hypertile 32 evaluation")


def phase_slice_f_big(port, card, models, cfg, zero_counts, read_path):
    """Slice F beyond 512² on the phase-5 models: (m) the fast preset at
    2048², 4 steps (DeepCache 3: 2 full evaluations, 2 shallow; Hypertile
    tiles levels 1-3, so K4 launches 0 times and K1 runs over the tiles);
    (n) Hypertile 32 at 2560², 2 steps, which the guard refuses without it
    (102400 level-1 tokens; a ragged 400-token tile at level 3)."""
    base_cfg = dataclasses.replace(cfg, conv_backend="kernel", vae_attention_backend="kernel")
    kw = dict(uncond_prompt="", cfg_scale=7.5, seed=1337, tokenizer=_tokenizer(),
              device="cuda", sampler_name="dpm++", timestep_spacing="karras",
              return_latents=True)
    fast_cfg, fast_kw = port.fast_preset(base_cfg)
    full, shallow = deepcache_evals("dpm++", 4, 0, fast_kw["deepcache"])
    c3_run(f"m fast preset 2048², 4 steps ({full} full, {shallow} shallow)",
           lambda: port.generate(PROMPTS[1], models=models, config=fast_cfg, height=2048,
                                 width=2048, n_inference_steps=4, **fast_kw, **kw),
           [(fast_cfg, 2048, 2048, 4, 0, 77, dict(shallow=shallow))], (2048, 2048, 3), card,
           zero_counts, read_path, slice_name="F")
    want = expected_launches(fast_cfg, 2048, 2048, steps=4, img2img=False, shallow=shallow)
    check(want["K4"] == 0 and want["K1"] > 0, f"F m: the plan {want} runs K4")
    try:
        port.generate(PROMPTS[1], models=models, config=base_cfg, height=2560, width=2560,
                      n_inference_steps=2, **kw)
    except ValueError as err:
        print(f"F n: 2560² without Hypertile: ValueError, as in the JAX package: {err}",
              flush=True)
    else:
        check(False, "F n: 2560² without Hypertile did not raise ValueError")
    ht = port.with_hypertile(base_cfg, 32)
    c3_run("n Hypertile 32 at 2560², 2 steps", lambda: port.generate(
        PROMPTS[1], models=models, config=ht, height=2560, width=2560, n_inference_steps=2,
        **kw), [(ht, 2560, 2560, 2, 0, 77)], (2560, 2560, 3), card, zero_counts, read_path,
        slice_name="F")


def phase_slice_f_xl(port, card, xl, xl_cfg, zero_counts, read_path):
    """Slice F on SDXL 1024², 10 dpm++ Karras steps, CFG 5 (after slice E's
    SDXL requests): (o) PAG 3.0, FreeU with the SDXL defaults, and Hypertile
    32 (level 1's 4096 tokens in four tiles)."""
    kw = dict(uncond_prompt="", cfg_scale=5.0, seed=1337, tokenizer=_tokenizer(),
              device="cuda", height=1024, width=1024, return_latents=True,
              sampler_name="dpm++", timestep_spacing="karras", n_inference_steps=10)

    def run(label, config=xl_cfg, plan=None, **more):
        return c3_run(label, lambda: port.generate(PROMPTS[0], models=xl, config=config,
                                                   **{**kw, **more}),
                      [(config, 1024, 1024, 10, 0, 77, plan or {})], (1024, 1024, 3), card,
                      zero_counts, read_path, slice_name="F")

    run("o SDXL PAG 3.0", pag_scale=3.0, plan=dict(pag=True))
    run("o SDXL freeu=True (1.3, 1.4, 0.9, 0.2)", freeu=True)
    run("o SDXL Hypertile 32", config=port.with_hypertile(xl_cfg, 32))


# ------------------------------------------------------------------ slice G
def motion_file(port, cfg, path, seed):
    """AnimateDiff motion modules for ``cfg``'s UNet drawn from ``seed`` on
    the card (every site of the v2 topology, one block each), written in the
    published ``mm_sd_v15_v2`` key schema as fp16 .safetensors with the
    ``pos_encoder.pe`` buffers of a 32-frame window; -> (parameters, the
    file's tensors cast to the compute dtype, by the port's key)."""
    from pytorch_stable_diffusion_tpu_torch.models import motion
    from pytorch_stable_diffusion_tpu_torch.weights import animatediff, save

    mods = motion.build(cfg.unet, generator=torch.Generator(device="cuda").manual_seed(seed),
                        dtype=torch.float32, device="cuda")
    n_params = sum(p.numel() for p in mods.parameters())
    sd = {k: v if k.endswith("pe") else v.half()
          for k, v in animatediff.deconvert_motion_module(mods, cfg.unet, 32).items()}
    save.write_safetensors(sd, path)
    want = {k: v.half().to(cfg.policy.param_dtype) for k, v in mods.state_dict().items()}
    return n_params, want


def esrgan_file(path, seed):
    """A RealESRGAN_x4plus-width RRDBNet (64 features, 23 RRDBs, growth 32)
    drawn from ``seed`` on the card, written flat in the new-arch key schema
    as fp32 .safetensors; -> its parameter count."""
    from pytorch_stable_diffusion_tpu_torch.models import esrgan
    from pytorch_stable_diffusion_tpu_torch.weights import save

    net = esrgan.build(esrgan.ESRGANConfig(), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(seed))
    save.write_safetensors(net.state_dict(), path)
    return sum(p.numel() for p in net.parameters())


def phase_slice_g(port, card, models, cfg, zero_counts, read_path):
    """Slice G at SD-1.5 full width, BF16, kernel attention, conv and VAE,
    seed 1337, on the phase-5 models: (a) ``with_motion`` on a file in the
    ``mm_sd_v15_v2`` key schema (21 modules, a 32-frame window), ``animate``
    16 frames at 512², dpm++ Karras 10 steps, CFG 7.5 (32 lanes an
    evaluation), and (a') again, bit-identical; (b) 24 frames through
    ``motion_window=16`` (windows at frames 0 and 8); (c) ``panorama``
    512x2048, window 512, stride 256 (7 windows), 10 steps, and a
    single-window 512² panorama bit-identical to plain ``generate``; (d)
    ``panorama`` 2048x4096, 1 step (105 windows; the JAX package's guard
    refuses the canvas, the port counts a window), the decode's mid block
    on K3 over 131072 tokens and its tail tiled (``decode_tile=64``: whole,
    its 256-channel upsample would hold 2^31 elements, past the 32-bit
    indexing of torch's conv); (e) ``with_upscaler`` on a file in the
    new-arch key schema at RealESRGAN_x4plus's widths, ``upscale`` 512² ->
    2048² whole and tiled (tile 192, pad 8, 8 lanes; their PSNR printed,
    not gated); (f) ``hires_fix`` 512² -> 1024² with
    ``upscale_method="esrgan"``, strength 0.6; (g) ``sd_upscale`` of a 512²
    image x2 (9 tiles in chunks of 4, strength 0.3).  Each request's
    launches are held to the plan (windows x an evaluation's launches; the
    VAE passes at the canvas); its wall time and peak memory printed.  One
    AnimateDiff evaluation (32 lanes) profiled with and without the motion
    modules, and one panorama window."""
    import os
    import tempfile

    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.models.esrgan import ESRGANConfig
    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm

    base_cfg = dataclasses.replace(cfg, conv_backend="kernel", vae_attention_backend="kernel")
    tok = _tokenizer()
    sd = port.StableDiffusion(models, tok, base_cfg, device="cuda")
    kw = dict(cfg_scale=7.5, seed=1337, sampler_name="dpm++", timestep_spacing="karras",
              n_inference_steps=10)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_g_")

    def run(label, fn, parts, shape):
        return c3_run(label, fn, parts, shape, card, zero_counts, read_path, slice_name="G")

    def same(x, y, what):
        x, y = (v if isinstance(v, tuple) else (v,) for v in (x, y))
        check(all(np.array_equal(a, b) for a, b in zip(x, y)), f"G {what}: not bit-identical")

    # (a) AnimateDiff from a file in the published schema
    t0 = time.perf_counter()
    path = os.path.join(tmp.name, "mm_sd_v15_v2.safetensors")
    n_params, want = motion_file(port, base_cfg, path, seed=14)
    t1 = time.perf_counter()
    sd_m = sd.with_motion(path)
    torch.cuda.synchronize()
    got = sd_m.models["motion"].state_dict()
    check(sd_m._motion_max == 32 and len(sd_m.models["motion"]) == 21,
          f"G a: {len(sd_m.models['motion'])} modules, a {sd_m._motion_max}-frame window")
    check(got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want),
          "G a: the loaded motion modules are not the file's")
    print(f"G motion file: {n_params} parameters in 21 modules, fp16 .safetensors "
          f"({os.path.getsize(path) / 2**30:.2f} GiB) written in {t1 - t0:.1f} s, loaded by "
          f"with_motion in {time.perf_counter() - t1:.1f} s, every tensor the file's",
          flush=True)
    anim = dict(kw, height=512, width=512)
    a = run("a animate 16 frames 512²", lambda: sd_m.animate(PROMPTS[0], n_frames=16, **anim),
            [(base_cfg, 512, 512, 10, 0, 77)], (16, 512, 512, 3))
    same(a, run("a' animate again", lambda: sd_m.animate(PROMPTS[0], n_frames=16, **anim),
                [(base_cfg, 512, 512, 10, 0, 77)], (16, 512, 512, 3)), "a'")
    check(not np.array_equal(a[0], a[1]), "G a: frames 0 and 1 are equal")
    b = run("b animate 24 frames, motion_window 16 (windows at 0 and 8)",
            lambda: sd_m.animate(PROMPTS[0], n_frames=24, motion_window=16, **anim),
            [(base_cfg, 512, 512, 10 * 2, 0, 77)], (24, 512, 512, 3))
    # (c), (d) panoramas: the UNet over windows, the VAE over the canvas
    pano = dict(kw, panorama=True, panorama_window=512, return_latents=True)
    c = run("c panorama 512x2048, window 512, stride 256 (7 windows)",
            lambda: sd.txt2img(PROMPTS[1], height=512, width=2048, panorama_stride=256, **pano),
            [(base_cfg, 512, 512, 10 * 7, 0, 77, dict(canvas=(512, 2048)))], (512, 2048, 3))
    one = dict(kw, height=512, width=512, return_latents=True)
    plain = run("c' generate 512²", lambda: sd.txt2img(PROMPTS[1], **one),
                [(base_cfg, 512, 512, 10, 0, 77)], (512, 512, 3))
    same(run("c' panorama 512², one window", lambda: sd.txt2img(PROMPTS[1], panorama=True,
                                                                  panorama_window=512, **one),
             [(base_cfg, 512, 512, 10, 0, 77)], (512, 512, 3)), plain, "c' (one window)")
    run("d panorama 2048x4096, 1 step (105 windows), decode_tile 64",
        lambda: sd.txt2img(PROMPTS[1], height=2048, width=4096, decode_tile=64,
                           **dict(pano, n_inference_steps=1)),
        [(base_cfg, 512, 512, 105, 0, 77, dict(canvas=(2048, 4096)))], (2048, 4096, 3))
    # (e), (f), (g) the upscalers
    path = os.path.join(tmp.name, "RealESRGAN_x4plus.safetensors")
    n_esr = esrgan_file(path, seed=15)
    sd_u = sd.with_upscaler(path)
    check(sd_u._upscaler.cfg == ESRGANConfig(),
          f"G e: config read from the file {sd_u._upscaler.cfg}")
    image = a[0]
    whole = run("e upscale 512² -> 2048², whole", lambda: sd_u.upscale(image), [],
                (2048, 2048, 3))
    tiled = run("e upscale 512² -> 2048², tiles 192, pad 8, 8 lanes",
                lambda: sd_u.upscale(image, tile=192), [], (2048, 2048, 3))
    print(f"G e: RRDBNet {n_esr} parameters; tiled vs whole PSNR "
          f"{psnr(tiled.astype(np.float32), whole.astype(np.float32)):.1f} dB (not gated: "
          f"the 8-pixel pad is under the receptive field)", flush=True)
    s06 = ddpm.start_step_for_strength(10, 0.6)
    run("f hires_fix 512² -> 1024², esrgan, strength 0.6",
        lambda: sd_u.hires_fix(PROMPTS[2], height=1024, width=1024, strength=0.6,
                               upscale_method="esrgan", **kw),
        [(base_cfg, 512, 512, 10, 0, 77), (base_cfg, 1024, 1024, 10 - s06, 1, 77)],
        (1024, 1024, 3))
    s03 = ddpm.start_step_for_strength(10, 0.3)
    run("g sd_upscale 512² x2 (9 tiles, chunks of 4), strength 0.3",
        lambda: sd.sd_upscale(PROMPTS[2], image, scale=2.0, strength=0.3, overlap=64,
                              height=512, width=512, **kw),
        [(base_cfg, 512, 512, 10 - s03, 1, 77)] * 3, (1024, 1024, 3))
    print(f"G: a' == a and the one-window panorama == generate, bit-identical; b's frames "
          f"0-7 vs a's (not gated) PSNR {psnr(b[:8].astype(np.float32), a[:8].astype(np.float32)):.1f} "
          f"dB", flush=True)
    del sd_u
    profile_g_evals(sd_m.models, base_cfg, card)
    del sd_m
    tmp.cleanup()
    torch.cuda.empty_cache()


def profile_g_evals(models, cfg, card, size=512):
    """One AnimateDiff evaluation (16 frames x CFG: 32 lanes) profiled as in
    phase 7, with and without the motion modules: their device time is the
    difference of the two busy times; and one panorama window (batch 2)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    dtype = cfg.policy.compute_dtype
    lat = size // cfg.vae.downsample_factor
    x = torch.randn(32, 4, lat, lat, device="cuda", generator=g).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    ctx = torch.randn(32, 77, cfg.unet.d_context, device="cuda", generator=g).to(dtype)
    t = torch.tensor(500.0, device="cuda")
    kw = dict(attention_backend=cfg.attention_backend, conv_backend=cfg.conv_backend)
    u = models["diffusion"]

    def evaluation(motion=None, lanes=32):
        def step():
            with torch.inference_mode():
                return u(x[:lanes], ctx[:lanes], t, cfg.policy, motion=motion, frames=16, **kw)
        return step

    where = f"step G SD-1.5 ({size}², {cfg.conv_backend})"
    _, busy = profile_eval(evaluation(models["motion"]), card,
                           f"{where}: one AnimateDiff evaluation, 32 lanes (16 frames x CFG)")
    _, busy0 = profile_eval(evaluation(), card, f"{where}: the same 32 lanes without the "
                                                f"motion modules")
    print(f"{where}: the 21 motion modules' device time {(busy - busy0) * 1e3:.2f} ms of "
          f"{busy * 1e3:.2f} ms, a share of {(busy - busy0) / busy:.3f}  [{card}]", flush=True)
    profile_eval(evaluation(lanes=2), card, f"{where}: one panorama window (batch 2)")


def phase_small_g(port, cpu, base):
    """Slice G at full width, FP32, 256², 1 dpm++ step, CFG 5: the card
    (kernel attention, conv and VAE) against the port's CPU plain path on
    the same seeded weights and noise (> 55 dB latents, > 40 dB image, the
    plan's launches): animate 3 frames and 4 frames through windows of 3
    (frames 0-2 and 1-3), with SD-1.5's 21 motion modules drawn from a seed
    on the CPU, and a 256x384 panorama (window 256, stride 128: 2
    windows)."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.models import motion

    tok = _tokenizer()
    mods = motion.build(base.unet, generator=torch.Generator().manual_seed(34), device="cpu")
    cpu = dict(cpu, motion=mods)
    kw = dict(uncond_prompt="a dog", cfg_scale=5.0, seed=17, height=256, width=256,
              tokenizer=tok, return_latents=True, n_inference_steps=1, sampler_name="dpm++")
    cfg_g = dataclasses.replace(base, attention_backend="kernel", vae_attention_backend="kernel",
                                conv_backend="kernel")
    gpu = port.build_models(cfg_g, device="cuda",
                            state_dicts={k: m.state_dict() for k, m in cpu.items()})
    check("motion" in gpu and len(gpu["motion"]) == 21, "small G: the motion modules")
    requests = (  # label, options, UNet calls, the VAE's canvas
        ("animate 3 frames", dict(n_frames=3), 1, None),
        ("4 frames, motion_window 3", dict(n_frames=4, motion_window=3), 2, None),
        ("panorama 256x384, window 256, stride 128", dict(
            width=384, panorama=True, panorama_window=256, panorama_stride=128), 2, (256, 384)))
    for label, opts, calls, canvas in requests:
        t1 = time.perf_counter()
        img_c, lat_c = port.generate(
            PROMPTS[0], models=cpu, device="cpu", **{**kw, **opts},
            config=dataclasses.replace(cfg_g, attention_backend="plain",
                                       vae_attention_backend="plain", conv_backend="plain"))
        t_cpu = time.perf_counter() - t1
        want = expected_launches(cfg_g, 256, 256, steps=calls, img2img=False, canvas=canvas)
        before = launch_counts()
        img_g, lat_g = port.generate(PROMPTS[0], models=gpu, config=cfg_g, device="cuda",
                                     **{**kw, **opts})
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in launch_counts().items()}
        lat_db = psnr(lat_c, lat_g)
        img_db = psnr(img_c.astype(np.float32), img_g.astype(np.float32))
        print(f"small G ({label}): full-width FP32 256², 1 dpm++ step, CFG 5, card vs CPU "
              f"plain path: latents PSNR {lat_db:.1f} dB, image PSNR {img_db:.1f} dB, launches "
              f"{got}; CPU side {t_cpu:.1f} s", flush=True)
        check(got == want, f"small G ({label}) launched {got}, want {want}")
        check(np.isfinite(lat_g).all(), f"small G ({label}): latents not finite")
        check(lat_db > 55.0, f"small G ({label}) latents PSNR {lat_db:.1f} dB <= 55")
        check(img_db > 40.0, f"small G ({label}) image PSNR {img_db:.1f} dB <= 40")
    del gpu, cpu, mods
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ slice H2
H2_TIERS = ("none", "wide", "conv", "w8")


def profile_quant_eval(models, cfg, card):
    """One UNet evaluation of SD-1.5 at 512², CFG batch 2, under ``cfg``'s
    int8 tier, its weights quantized by the evaluation before (as inside a
    request): wall time, device busy time and share under torch.profiler,
    the device time under ``aten::_int_mm`` (cuBLASLt's int8 product) and
    its share, and the peak device memory of the evaluation; -> (busy s,
    _int_mm s)."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_stable_diffusion_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 4, 64, 64, device="cuda", generator=g).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    ctx = torch.randn(2, 77, 768, device="cuda", generator=g).to(torch.bfloat16)
    t = torch.tensor(500.0, device="cuda")

    def step():
        return models["diffusion"](x, ctx, t, cfg.policy, attention_backend="kernel",
                                   conv_backend=cfg.conv_backend, quant=cfg.quant)

    with torch.inference_mode(), quant.weight_cache():
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    rows = prof.key_averages()
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0) / 1e6
    int_mm = sum(e.device_time_total for e in rows if e.key == "aten::_int_mm") / 1e6
    n_mm = sum(e.count for e in rows if e.key == "aten::_int_mm")
    share = (f"busy share {busy / prof_wall:.3f}, _int_mm {int_mm * 1e3:.3f} ms in {n_mm} "
             f"calls ({int_mm / busy:.3f} of the device time)") if busy > 0 \
        else "device time not measured"
    tier = f"conv_backend={cfg.conv_backend}" + (" (K5 off)" if cfg.quant != "none" else "")
    print(f"H2 a eval quant={cfg.quant}: one UNet evaluation (512², batch 2, {tier}) "
          f"{wall * 1e3:.2f} ms wall; profiled {prof_wall * 1e3:.2f} ms wall, "
          f"{busy * 1e3:.2f} ms device busy, {share}; peak {peak:.2f} GiB  [{card}]",
          flush=True)
    return busy, int_mm


def phase_h2_int8(card):
    """(b): ``int8_linear`` and ``int8_conv`` on the card and on the CPU
    from the same seeded inputs at the widest SD-1.5 shapes (and a product
    of M <= 16, which ``int_mm`` pads): equal int8 values, scales and int32
    accumulators, outputs within fp32 rounding; the card's ``_int_mm``
    beside the bf16 product and cuDNN's bf16 conv."""
    import torch.nn.functional as F

    from pytorch_stable_diffusion_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(11)
    cases = {"linear (2, 256, 1280)·(1280, 1280)": (torch.randn(2, 256, 1280, generator=g),
                                                     torch.randn(1280, 1280, generator=g)),
             "linear (1, 9, 1280)·(1280, 1280), M padded": (
                 torch.randn(1, 9, 1280, generator=g), torch.randn(1280, 1280, generator=g)),
             "conv 3x3 (2, 16², 1280 -> 1280)": (torch.randn(2, 1280, 16, 16, generator=g),
                                                 torch.randn(1280, 1280, 3, 3, generator=g))}
    bias = torch.randn(1280, generator=g)
    for label, (x, w) in cases.items():
        conv = w.dim() == 4
        dims = tuple(range(x.dim()))
        out, accs = {}, {}
        for dev in ("cpu", "cuda"):
            xd, wd, bd = x.to(dev), (w * 0.02).to(dev), bias.to(dev)
            xq, xs = quant.quantize(xd, dims)
            wq, ws = quant.quantize(wd, tuple(range(1, w.dim())))
            accs[dev] = (xq.cpu(), xs.cpu(), wq.cpu(), ws.cpu(),
                         (quant.conv_int32(xq, wq, w.shape[2:], padding=1) if conv
                          else quant.int_mm(xq.reshape(-1, 1280), wq)).cpu())
            out[dev] = (quant.int8_conv(xd, wd, padding=1, bias=bd) if conv
                        else quant.int8_linear(xd, wd, bd)).cpu()
        for name, a, b in zip(("x int8", "x scale", "w int8", "w scales", "int32 sums"),
                              accs["cpu"], accs["cuda"]):
            check(torch.equal(a, b), f"H2 b {label}: {name} differ between card and CPU")
        err = float((out["cuda"] - out["cpu"]).abs().max())
        top = float(out["cpu"].abs().max())
        check(err <= 1e-6 * top, f"H2 b {label}: outputs differ by {err} (max |y| {top})")
        xd, wd = x.cuda().to(torch.bfloat16), (w * 0.02).cuda().to(torch.bfloat16)
        xq, _ = quant.quantize(xd, dims)
        wq, _ = quant.quantize(wd, tuple(range(1, w.dim())))
        if conv:
            ms = cuda_ms(lambda: quant.conv_int32(xq, wq, (3, 3), padding=1), iters=50)
            ref = cuda_ms(lambda: F.conv2d(xd.contiguous(memory_format=torch.channels_last),
                                           wd.contiguous(memory_format=torch.channels_last),
                                           padding=1), iters=50)
            what = "im2col + _int_mm"
        else:
            a2, w2 = xq.reshape(-1, 1280), wq.reshape(1280, -1)
            ms = cuda_ms(lambda: quant.int_mm(a2, w2), iters=50)
            ref = cuda_ms(lambda: F.linear(xd, wd), iters=50)
            what = "_int_mm"
        print(f"H2 b {label}: int8 values, scales and int32 sums equal on the card and the "
              f"CPU, outputs within {err:.2e} (max |y| {top:.1f}); {what} {ms:.4f} ms, the "
              f"bf16 {'conv (cuDNN)' if conv else 'product'} {ref:.4f} ms  [{card}]",
              flush=True)


def phase_slice_h2(port, card, request, zero_counts, read_path):
    """Slice H2 at SD-1.5 512² full width, BF16, kernel attention (the
    module docstring's phase 9)."""
    import os
    import socket
    import tempfile

    import numpy as np
    from PIL import Image

    from pytorch_stable_diffusion_tpu_torch.core import mesh as mesh_mod
    from pytorch_stable_diffusion_tpu_torch.models import state_dicts
    from pytorch_stable_diffusion_tpu_torch.parallel import dp, tp
    from pytorch_stable_diffusion_tpu_torch.utils import metrics, profiling
    from pytorch_stable_diffusion_tpu_torch.weights import save
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import CLIPTokenizer

    t_phase = time.perf_counter()
    cfg = port.sd15_config(policy=port.BF16, attention_backend="kernel",
                           conv_backend="kernel")
    models = port.build_models(cfg, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(0))
    tok = _tokenizer()
    kw = dict(uncond_prompt="", cfg_scale=7.5, sampler_name="dpm++", timestep_spacing="karras",
              n_inference_steps=20, seed=1337, height=512, width=512, models=models,
              tokenizer=tok, device="cuda")

    # (a) the tiers through generate(): launches, PSNR against "none", one
    # evaluation's device time, _int_mm's share and the peak memory
    images, k1 = {}, {}
    for tier in H2_TIERS:
        tcfg = dataclasses.replace(cfg, quant=tier)
        zero_counts()
        images[tier] = request(f"H2 a quant={tier}",
                               lambda: port.generate(PROMPTS[0], config=tcfg, **kw),
                               size=512, steps=20, n_images=1, config=tcfg)
        counts = launch_counts()
        read_path()
        k1[tier] = counts["K1"]
        if tier != "none":
            check(counts["K5"] == 0, f"H2 a quant={tier}: K5 launched {counts['K5']} times")
        else:
            check(counts["K5"] == 20 * K5_PER_EVAL, f"H2 a none: K5 launched {counts['K5']}")
    check(len(set(k1.values())) == 1, f"H2 a: K1 launches differ across the tiers: {k1}")
    print("H2 a image PSNR against quant=none (same seed, 20-step dpm++ Karras): "
          + ", ".join(f"{tier} {metrics.image_psnr(images[tier], images['none']):.2f} dB"
                      for tier in H2_TIERS[1:])
          + f"; K1 {k1['none']} launches in each, K5 0 under every tier  [{card}]", flush=True)
    # "none" on the plain convs too: the tiers run the res blocks on them
    for tier, convs in (("none", "plain"),) + tuple((t, "kernel") for t in H2_TIERS):
        profile_quant_eval(models, dataclasses.replace(cfg, quant=tier, conv_backend=convs),
                           card)

    # (b) int8 on the card against the CPU
    phase_h2_int8(card)

    # (c) the CLI in a subprocess, on a full-width file the port writes
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_h2_")
    d = tmp.name
    vocab, merges = _tokenizer_files(tok, d)
    ckpt, png = os.path.join(d, "sd15.safetensors"), os.path.join(d, "cli.png")
    t0 = time.perf_counter()
    save.save_safetensors(state_dicts(models), cfg, ckpt, dtype=torch.bfloat16)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "pytorch_stable_diffusion_tpu_torch",
                          "--ckpt", ckpt, "--vocab", vocab, "--merges", merges,
                          "--prompt", PROMPTS[0], "--bf16", "--steps", "4", "--seed", "1337",
                          "--out", png], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    t_cli = time.perf_counter() - t0
    check(cli.returncode == 0, f"H2 c: the CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    cli_cfg = port.sd15_config(policy=port.BF16, attention_backend="kernel")
    sd = port.StableDiffusion(models, CLIPTokenizer.from_files(vocab, merges, max_len=77),
                              cli_cfg)
    want = sd.txt2img(PROMPTS[0], seed=1337, n_inference_steps=4)
    got = np.asarray(Image.open(png).convert("RGB"))
    check(np.array_equal(got, want), "H2 c: the CLI's PNG differs from StableDiffusion.txt2img")
    info = Image.open(png).text.get("parameters", "")
    check(info.startswith(PROMPTS[0]) and "Steps: 4, Sampler: ddpm" in info,
          f"H2 c: infotext {info!r}")
    print(f"H2 c CLI: python -m pytorch_stable_diffusion_tpu_torch --bf16 --steps 4 on a "
          f"{os.path.getsize(ckpt) / 2**30:.2f} GiB bf16 file (written in {t_save:.1f} s): "
          f"{t_cli:.1f} s in the subprocess, PNG equal to StableDiffusion.txt2img, infotext "
          f"{info.splitlines()[-1]!r}  [{card}]", flush=True)
    os.remove(ckpt)

    # (d) DP and TP at world size 1 over NCCL, against the single card
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port_no}",
                                         rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_mesh(data=1, model=1)
        bkw = dict(kw, config=cfg, n_inference_steps=8)
        del bkw["uncond_prompt"]
        one = port.generate_images(PROMPTS[:2], **bkw)
        zero_counts()
        got_dp = dp.generate_images_dp(PROMPTS[:2], mesh=mesh, **bkw)
        got_tp = tp.generate_images_tp(PROMPTS[:2], mesh=mesh, **bkw)
        counts = launch_counts()
        read_path()
        check(np.array_equal(got_dp, one), "H2 d: generate_images_dp differs from one card")
        check(np.array_equal(got_tp, one), "H2 d: generate_images_tp differs from one card")
        print(f"H2 d NCCL world size 1 ({mesh.device_type} mesh 1x1): generate_images_dp and "
              f"generate_images_tp of 2 prompts, 8 steps, equal the single card's images bit "
              f"for bit; launches {counts}  [{card}]", flush=True)
    finally:
        torch.distributed.destroy_process_group()

    # (e) device_trace names K1's kernel
    zero_counts()
    with profiling.device_trace(os.path.join(d, "trace")) as prof:
        with profiling.phase("h2 request"):
            port.generate(PROMPTS[0], config=cfg, **dict(kw, n_inference_steps=2))
    counts = launch_counts()
    read_path()
    (trace,) = os.listdir(os.path.join(d, "trace"))
    with open(os.path.join(d, "trace", trace)) as f:
        text = f.read()
    names = {e.key for e in prof.key_averages()}
    check(counts["K1"] > 0 and "attention_tc_kernel" in text and "h2 request" in text,
          f"H2 e: the trace does not name K1's kernel (K1 launches {counts['K1']})")
    print(f"H2 e device_trace: {len(text) / 2**20:.1f} MiB Chrome trace, {len(names)} event "
          f"names, K1's attention_tc_kernel and the 'h2 request' range in it; K1 launched "
          f"{counts['K1']} times  [{card}]", flush=True)
    tmp.cleanup()
    print(f"H2: {time.perf_counter() - t_phase:.1f} s in all  [{card}]", flush=True)


#: slice H3a's requests: (label, policy, size, steps, bar): the bar is the
#: PSNR floor against one process in dB, or None for one uint8 level
H3A_REQUESTS = (("a", "BF16", 512, 8, 35.0), ("b", "BF16", 2048, 2, 35.0),
                ("c", "FP32", 256, 8, None))


def h3a_request_kw(port, models, cfg, size, steps):
    return dict(cfg_scale=7.5, sampler_name="dpm++", timestep_spacing="karras",
                n_inference_steps=steps, seed=1337, height=size, width=size, models=models,
                config=cfg, tokenizer=_tokenizer(), device="cuda")


def h3a_models(port, policy):
    """SD-1.5 at full width on the card, kernel attention, seed-0 weights:
    every rank and the one-process reference build the same."""
    cfg = port.sd15_config(policy=getattr(port, policy), attention_backend="kernel")
    return cfg, port.build_models(cfg, device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(0))


def h3a_rank(rank, world, port_no, out_dir):
    """One gloo rank of slice H3a on the one card: each request of
    :data:`H3A_REQUESTS` through ``parallel/sp.generate_spatial`` over a (1,
    world) mesh, its launches counted from 0 and its wall time taken;
    saves them with the image."""
    import datetime
    import os

    import pytorch_stable_diffusion_tpu_torch as port
    from pytorch_stable_diffusion_tpu_torch.core import mesh as mesh_mod
    from pytorch_stable_diffusion_tpu_torch.parallel import sp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port_no}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    try:
        mesh = mesh_mod.make_mesh(data=1, model=world)
        out, built, models = {}, None, None
        for label, policy, size, steps, _ in H3A_REQUESTS:
            if built != policy:
                models = None
                torch.cuda.empty_cache()
                cfg, models = h3a_models(port, policy)
                built = policy
            kw = h3a_request_kw(port, models, cfg, size, steps)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            image = sp.generate_spatial(PROMPTS[0], mesh=mesh, **kw)
            torch.cuda.synchronize()
            out[label] = dict(image=image, seconds=time.perf_counter() - t0,
                              launches=launch_counts())
        torch.save(out, os.path.join(out_dir, f"h3a_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_slice_h3a(port, card, zero_counts, read_path, main_launches):
    """Slice H3a: sequence parallelism as two gloo ranks on the one card
    (the module docstring's phase 10).  Each request of :data:`H3A_REQUESTS`
    on one process first (the reference), then on the ranks; every rank's
    image is the whole image, within the request's bar of the reference,
    and its launches are the plan's (``expected_launches(sp=2)``), which
    join the main paths' counts."""
    import socket
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    from pytorch_stable_diffusion_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    world = 2
    want, one_s = {}, {}
    zero_counts()
    for policy in ("BF16", "FP32"):
        cfg, models = h3a_models(port, policy)
        for label, pol, size, steps, _ in H3A_REQUESTS:
            if pol != policy:
                continue
            kw = h3a_request_kw(port, models, cfg, size, steps)
            port.generate(PROMPTS[0], **dict(kw, n_inference_steps=1))  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want[label] = port.generate(PROMPTS[0], **kw)
            torch.cuda.synchronize()
            one_s[label] = time.perf_counter() - t0
        del models
        torch.cuda.empty_cache()
    read_path()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_h3a_")
    t0 = time.perf_counter()
    mp.spawn(h3a_rank, args=(world, port_no, tmp.name), nprocs=world, join=True)
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp.name}/h3a_rank{r}.pt", weights_only=False)
             for r in range(world)]
    tmp.cleanup()
    for label, policy, size, steps, bar in H3A_REQUESTS:
        cfg = port.sd15_config(policy=getattr(port, policy), attention_backend="kernel")
        plan = expected_launches(cfg, size, size, steps=steps, img2img=False, sp=world)
        ref = want[label]
        for r, res in enumerate(ranks):
            got = res[label]
            name = f"H3a {label} rank {r}"
            image = got["image"]
            check(image.dtype == np.uint8 and image.shape == ref.shape == (size, size, 3),
                  f"{name}: image {image.dtype} {image.shape}")
            check(image.max() > image.min(), f"{name}: constant image")
            diff = int(np.abs(image.astype(np.int16) - ref.astype(np.int16)).max())
            db = metrics.image_psnr(image, ref)
            if bar is None:
                check(diff <= 1, f"{name}: {diff} uint8 levels from one process")
            else:
                check(db > bar, f"{name}: {db:.2f} dB from one process (bar {bar})")
            check(got["launches"] == plan, f"{name}: launched {got['launches']}, want {plan}")
            check(np.array_equal(image, ranks[0][label]["image"]),
                  f"{name}: differs from rank 0's image")
            for k, v in got["launches"].items():
                main_launches[k] += v
            print(f"H3a {label} SD-1.5 {policy} {size}², {steps} dpm++ Karras steps, CFG 7.5, "
                  f"rank {r} of {world} (two gloo ranks sharing one card): "
                  f"{got['seconds']:.2f} s wall (one process {one_s[label]:.2f} s); "
                  f"{db:.2f} dB, max {diff} uint8 levels from one process; launches "
                  f"{got['launches']} (the plan's)  [{card}]", flush=True)
    print(f"H3a: {time.perf_counter() - t_phase:.1f} s in all, the ranks' spawn "
          f"{t_ranks:.1f} s  [{card}]", flush=True)


# ------------------------------------------------------------ slice H3b
def h3b_ops(card):
    """Each of the five custom ops called once on the card through
    ``torch.ops.sdt_torch``, at a phase-3 case's shape (K2 and K4 are not
    on the 512² artifact's path), held to its plain version with phase 3's
    tolerance; -> the errors by kernel."""
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as k5
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa

    ops, bf = torch.ops.sdt_torch, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(31)
    qkv = torch.randn(2, 1024, 3 * 640, device="cuda", generator=g).to(bf)
    q1, k1, v1 = qkv.split(640, dim=-1)
    q2, k2, v2 = cross_views(2, 1024, 308, 8, 80, bf, g)
    q4, k4, v4 = fused_views(1, 999, 41000, 2, 40, bf, g)
    q3, k3, v3 = fused_views(1, 4096, 4096, 1, 512, bf, g)
    x, gn, weight, bias, temb = k5_inputs(2, 64, 64, 320, 320, bf, g)
    scale, shift = k5.fold_gn_affine(gn, x, 32, temb=temb)
    cases = (  # short name, shape, the op's call, the plain version's
        ("K1", "(2, 1024, 640), 8 heads", lambda: ops.flash_attention_bsc(q1, k1, v1, 8),
         lambda: fa.flash_attention_bsc_plain(q1, k1, v1, 8)),
        ("K2", "(2, 8, 1024, 80) x KV 308",
         lambda: ops.flash_attention_onepass(q2, k2, v2, False),
         lambda: fa.flash_attention_onepass_plain(q2, k2, v2, False)),
        ("K4", "(1, 2, 999, 40) x KV 41000", lambda: ops.flash_attention_streamed(q4, k4, v4),
         lambda: fa.flash_attention_streamed_plain(q4, k4, v4)),
        ("K3", "(1, 1, 4096, 512)", lambda: ops.flash_attention_multipass(q3, k3, v3, False),
         lambda: fa.flash_attention_multipass_plain(q3, k3, v3, False)),
        ("K5", "(2, 64², 320 -> 320)",
         lambda: ops.scaled_silu_conv3x3(x, scale, shift, weight, bias),
         lambda: k5.scaled_silu_conv3x3_plain(x, scale, shift, weight, bias)),
    )
    errs = {}
    for short, shape, op, plain in cases:
        before = launch_counts()[short]
        got = op()
        torch.cuda.synchronize()
        check(launch_counts()[short] == before + 1, f"H3b op {short}: launched "
                                                    f"{launch_counts()[short] - before}")
        ref = plain()
        tol = (k5_tolerance if short == "K5" else tolerance)(bf, ref)
        errs[short] = max_err(got, ref)
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"H3b op {short}: {tuple(got.shape)} {got.dtype}")
        check(errs[short] <= tol, f"H3b op {short} {shape}: max err {errs[short]:.3g} > {tol:.3g}")
        print(f"H3b op {short} torch.ops.sdt_torch, {shape} bf16: max err {errs[short]:.3g} "
              f"(tol {tol:.3g})  [{card}]", flush=True)
    return errs


def phase_slice_h3b(port, card, zero_counts, read_path):
    """Slice H3b, the exported program (``utils/aot.py``) at SD-1.5 512² BF16
    full width, the attention, the res blocks and the VAE on the kernels
    (K1, K5, K3 inside the artifact): export txt2img (50 DDPM steps, CFG)
    and img2img, each under 64 MiB (no weight in it), saved, loaded and
    primed; seed 1337 bit-identical to eager ``generate`` with the plan's
    launches during the call; img2img at strengths 0.8 and 0.5 from one
    artifact, each bit-identical to eager; a second model's weights through
    the same artifact, equal to eager with them and not to the first
    model's image; the five ops through ``torch.ops``.  Lines ``H3b ...``;
    -> the txt2img artifact (loaded), its models, config and tokenizer."""
    import os
    import tempfile

    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm
    from pytorch_stable_diffusion_tpu_torch.utils import aot

    t_phase = time.perf_counter()
    cfg = port.sd15_config(policy=port.BF16, attention_backend="kernel",
                           conv_backend="kernel", vae_attention_backend="kernel")
    models = port.build_models(cfg, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(0))
    tok = _tokenizer()
    toks = np.asarray(tok.batch_encode([PROMPTS[0]]), np.int64)
    untoks = np.asarray(tok.batch_encode([""]), np.int64)
    eager_kw = dict(uncond_prompt="", do_cfg=True, cfg_scale=7.5, sampler_name="ddpm",
                    n_inference_steps=50, tokenizer=tok, config=cfg, device="cuda",
                    height=512, width=512, seed=1337, return_latents=True)
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return out

    arts = {}
    with tempfile.TemporaryDirectory() as d:
        for label, img2img in (("txt2img", False), ("img2img", True)):
            before = launch_counts()
            blob = timed(f"export {label}", lambda: aot.export_pipeline(
                cfg, models, n_steps=50, batch=1, height=512, width=512, img2img=img2img))
            check(launch_counts() == before, f"H3b export {label} launched kernels")
            check(len(blob) < 64 * 2**20, f"H3b {label} artifact is {len(blob)} bytes")
            path = os.path.join(d, f"{label}.sdt")
            timed(f"save {label}", lambda: open(path, "wb").write(blob))
            data = open(path, "rb").read()
            timed(f"load {label}", lambda: aot.load_pipeline(data))
            arts[label] = timed(f"prime {label}", lambda: aot.prime_pipeline(data, models))
            check(arts[label].platforms == ("cuda",), f"H3b platforms {arts[label].platforms}")
            print(f"H3b {label}: artifact {len(blob)} bytes; export {secs['export ' + label]:.1f}"
                  f" s, save {secs['save ' + label]:.3f} s, load {secs['load ' + label]:.1f} s, "
                  f"prime {secs['prime ' + label]:.1f} s  [{card}]", flush=True)

    def artifact_request(name, label, mods, steps, img2img, start=0, image=None):
        zero_counts()
        out = timed(name, lambda: arts[label](mods, toks, untoks, 1337, 7.5, start_step=start,
                                              input_image=image))
        launched = launch_counts()
        read_path()
        want = expected_launches(cfg, 512, 512, steps=steps, img2img=img2img)
        check(launched == want, f"H3b {name}: launched {launched}, want {want}")
        return out

    def eager(name, mods, **kw):
        return timed(name, lambda: port.generate(PROMPTS[0], models=mods,
                                                 **dict(eager_kw, **kw)))

    # seed 1337 against eager, twice for the first and a second call's wall
    img, lat = artifact_request("txt2img call 1", "txt2img", models, 50, False)
    img2, _ = artifact_request("txt2img call 2", "txt2img", models, 50, False)
    ref, ref_lat = eager("eager txt2img", models)
    check(np.array_equal(img[0], ref) and np.array_equal(lat, ref_lat),
          "H3b txt2img: the artifact differs from eager generate")
    check(np.array_equal(img, img2), "H3b txt2img: two calls differ")
    print(f"H3b txt2img seed 1337: bit-identical to eager (image and latents); wall "
          f"first call {secs['txt2img call 1']:.2f} s, second {secs['txt2img call 2']:.2f} s, "
          f"eager {secs['eager txt2img']:.2f} s; launches the plan's  [{card}]", flush=True)
    # img2img: one artifact, two strengths
    image = (ref.astype(np.float32) / 255.0) * 2.0 - 1.0
    for strength in (0.8, 0.5):
        start = ddpm.start_step_for_strength(50, strength)
        got, got_lat = artifact_request(f"img2img {strength}", "img2img", models, 50 - start,
                                        True, start=start, image=image[None])
        want, want_lat = eager(f"eager img2img {strength}", models, input_image=ref,
                               strength=strength)
        check(np.array_equal(got[0], want) and np.array_equal(got_lat, want_lat),
              f"H3b img2img {strength}: the artifact differs from eager generate")
        print(f"H3b img2img strength {strength} (start step {start}): bit-identical to eager; "
              f"wall {secs[f'img2img {strength}']:.2f} s, eager "
              f"{secs[f'eager img2img {strength}']:.2f} s  [{card}]", flush=True)
    # a second model's weights through the same artifact
    other = port.build_models(cfg, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(1))
    got, got_lat = artifact_request("txt2img other weights", "txt2img", other, 50, False)
    want, want_lat = eager("eager other weights", other)
    check(np.array_equal(got[0], want) and np.array_equal(got_lat, want_lat),
          "H3b other weights: the artifact differs from eager generate with them")
    check(not np.array_equal(got[0], ref), "H3b other weights gave the first model's image")
    print(f"H3b second model (seed 1) through the txt2img artifact: bit-identical to eager "
          f"with it, differs from the first model's image (PSNR "
          f"{psnr(got[0].astype(np.float32), ref.astype(np.float32)):.1f} dB)  [{card}]",
          flush=True)
    del other
    torch.cuda.empty_cache()
    h3b_ops(card)
    print(f"H3b: {time.perf_counter() - t_phase:.1f} s in all  [{card}]", flush=True)
    # slice I serves from the txt2img artifact
    return {"served": arts["txt2img"], "models": models, "cfg": cfg, "tok": tok}


# -------------------------------------------------------------- slice I
def example(name):
    """The module ``examples/<name>.py`` of this checkout."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def first_divergent_module(runs):
    """Where two runs part: ``runs`` holds two (models, fn) pairs, where
    ``fn(models)`` makes one short request; every module's tensor output is
    recorded in call order (forward hooks on every submodule of the models)
    and the two records are compared bit for bit; -> the first module whose
    output differs, by name and type, or None."""
    records = []
    for models, fn in runs:
        out = []

        def hook(mod, args, res, name):
            out.append((name, type(mod).__name__,
                        res.detach().clone() if isinstance(res, torch.Tensor) else None))
        hooks = [m.register_forward_hook(
                     lambda mod, args, res, name=f"{key}.{sub}": hook(mod, args, res, name))
                 for key, net in models.items() if isinstance(net, torch.nn.Module)
                 for sub, m in net.named_modules()]
        try:
            fn(models)
        finally:
            for h in hooks:
                h.remove()
        records.append(out)
    for (name, kind, a), (_, _, b) in zip(*records):
        if a is not None and b is not None and not torch.equal(a, b):
            return f"{name} ({kind})"
    return None


def weight_bytes(models):
    return sum(t.numel() * t.element_size() for m in models.values()
               for t in m.state_dict().values())


def phase_slice_i(port, card, request, zero_counts, read_path, d_files, h3b):
    """Slice I at SD-1.5 512² full width, attention, res blocks and VAE on
    the kernels (see the module docstring, phase 12): (a) the JAX quick
    start with the port's top-level names on slice D's checkpoint against
    ``StableDiffusion.from_checkpoint``; (b) MIXED against BF16 from the
    same bf16 values; (c) ``examples/torch_aot_serve.serve_request`` on
    H3b's txt2img artifact against eager ``generate``.  Lines ``I ...``."""
    import numpy as np

    from pytorch_stable_diffusion_tpu_torch.models import assemble

    cfg = port.sd15_config(policy=port.BF16, attention_backend="kernel",
                           conv_backend="kernel", vae_attention_backend="kernel")
    quick = dict(seed=1337, cfg_scale=7.5, n_inference_steps=20, height=512, width=512,
                 config=cfg, return_latents=True)

    # (a) the JAX quick start, the package name changed
    t = time.perf_counter()
    tokenizer = port.CLIPTokenizer.from_files(d_files["vocab"], d_files["merges"])
    models = port.load_models(d_files["ckpt"], cfg)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t
    zero_counts()
    resident = {"BF16": torch.cuda.memory_allocated()}
    img, lat = request("I a quick start: load_models + generate, 20 DDPM steps",
                       lambda: port.generate(PROMPTS[0], models=models, tokenizer=tokenizer,
                                             **quick), size=512, steps=20, n_images=1,
                       config=cfg)
    peak = {"BF16": torch.cuda.max_memory_allocated()}
    read_path()
    t = time.perf_counter()
    sd = port.StableDiffusion.from_checkpoint(d_files["ckpt"], d_files["vocab"],
                                              d_files["merges"], config=cfg)
    torch.cuda.synchronize()
    t_sd = time.perf_counter() - t
    zero_counts()
    ref, ref_lat = request("I a StableDiffusion.from_checkpoint txt2img, the same file and seed",
                           lambda: sd.txt2img(PROMPTS[0], **quick), size=512, steps=20,
                           n_images=1, config=cfg)
    read_path()
    del sd
    check(np.array_equal(img, ref) and np.array_equal(lat, ref_lat),
          "I a: the quick start's image differs from StableDiffusion.from_checkpoint's")
    print(f"I a quick start (CLIPTokenizer.from_files, load_models, generate): bit-identical "
          f"to StableDiffusion.from_checkpoint on slice D's file (image and latents); "
          f"load_models {t_load:.2f} s, from_checkpoint {t_sd:.2f} s (file -> card)  [{card}]",
          flush=True)

    # (b) MIXED from the BF16 weights' values held in fp32
    mixed_cfg = dataclasses.replace(cfg, policy=port.MIXED)
    mixed = assemble(mixed_cfg, {name: {k: v.float() for k, v in m.state_dict().items()}
                                 for name, m in models.items()})
    check({p.dtype for m in mixed.values() for p in m.parameters()} == {torch.float32},
          "I b: MIXED weights are not fp32")
    torch.cuda.synchronize()
    zero_counts()
    resident["MIXED"] = torch.cuda.memory_allocated()
    m_img, m_lat = request("I b MIXED (fp32 weights of the BF16 values), 20 DDPM steps",
                           lambda: port.generate(PROMPTS[0], models=mixed, tokenizer=tokenizer,
                                                 **dict(quick, config=mixed_cfg)),
                           size=512, steps=20, n_images=1, config=mixed_cfg)
    peak["MIXED"] = torch.cuda.max_memory_allocated()
    read_path()
    if np.array_equal(m_img, img) and np.array_equal(m_lat, lat):
        print(f"I b MIXED against BF16: bit-identical (image and latents)  [{card}]",
              flush=True)
    else:
        short = dict(quick, n_inference_steps=1)
        op = first_divergent_module(
            [(models, lambda m: port.generate(PROMPTS[0], models=m, tokenizer=tokenizer,
                                              **short)),
             (mixed, lambda m: port.generate(PROMPTS[0], models=m, tokenizer=tokenizer,
                                             **dict(short, config=mixed_cfg)))])
        db = psnr(m_img.astype(np.float32), img.astype(np.float32))
        print(f"I b MIXED against BF16: not bit-identical; first module whose output "
              f"differs: {op}; image PSNR {db:.2f} dB, latents max diff "
              f"{np.abs(m_lat - lat).max():.3g}  [{card}]", flush=True)
        check(db >= 50.0, f"I b: MIXED image {db:.2f} dB from BF16's (bar 50 dB; {op})")
    evals = {}
    for label, c, m in (("BF16", cfg, models), ("MIXED", mixed_cfg, mixed)):
        evals[label] = phase_step(m, c, card, size=512, context=77, label=f"I b SD-1.5 {label}")
    gib = {label: f"{peak[label] / 2**30:.3f} GiB over {resident[label] / 2**30:.3f} GiB "
                  f"resident" for label in peak}
    print(f"I b weights BF16 {weight_bytes(models) / 2**30:.3f} GiB, MIXED "
          f"{weight_bytes(mixed) / 2**30:.3f} GiB; a 20-step request's peak device memory "
          f"BF16 {gib['BF16']}, MIXED {gib['MIXED']} (both policies' weights); one UNet "
          f"evaluation's device time BF16 {evals['BF16'][1] * 1e3:.3f} ms, MIXED "
          f"{evals['MIXED'][1] * 1e3:.3f} ms (wall {evals['BF16'][0] * 1e3:.2f}, "
          f"{evals['MIXED'][0] * 1e3:.2f} ms)  [{card}]", flush=True)
    del mixed, models
    torch.cuda.empty_cache()

    # (c) the serving loop on H3b's txt2img artifact
    serve = example("torch_aot_serve")
    served, s_models, s_cfg, s_tok = h3b["served"], h3b["models"], h3b["cfg"], h3b["tok"]
    for seed, prompt in enumerate(PROMPTS[:3]):
        zero_counts()
        t = time.perf_counter()
        got = serve.serve_request(served, s_models, s_tok, prompt, seed=seed, cfg_scale=7.5)
        torch.cuda.synchronize()
        t_served = time.perf_counter() - t
        launched = launch_counts()
        read_path()
        want_launches = expected_launches(s_cfg, 512, 512, steps=50, img2img=False)
        check(launched == want_launches,
              f"I c request {seed}: launched {launched}, want {want_launches}")
        zero_counts()
        t = time.perf_counter()
        want = port.generate(prompt, models=s_models, tokenizer=s_tok, config=s_cfg, seed=seed,
                             cfg_scale=7.5, sampler_name="ddpm", n_inference_steps=50,
                             height=512, width=512, device="cuda")
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t
        read_path()
        check(got.shape == (1, 512, 512, 3) and got.dtype == np.uint8,
              f"I c request {seed}: {got.shape} {got.dtype}")
        check(np.array_equal(got[0], want),
              f"I c request {seed}: the served image differs from eager generate")
        print(f"I c request {seed} (seed {seed}, 50 DDPM steps, CFG 7.5): serve_request "
              f"bit-identical to eager generate; wall {t_served:.2f} s, eager {t_eager:.2f} s; "
              f"launches {launched}  [{card}]", flush=True)


def _tokenizer_files(tok, d):
    """vocab.json and merges.txt of the test tokenizer in directory ``d``."""
    import os

    vocab, merges = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
    with open(vocab, "w") as f:
        json.dump(tok.encoder, f)
    with open(merges, "w") as f:
        f.write("#version: 0.2\n" + "".join(
            f"{a} {b}\n" for a, b in sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)))
    return vocab, merges


# ------------------------------------------------------------------- main
def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")
    import numpy as np

    import pytorch_stable_diffusion_tpu_torch as port
    from pytorch_stable_diffusion_tpu_torch.models import param_count
    from pytorch_stable_diffusion_tpu_torch.ops import attention
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import build
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv as k5
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import flash_attention as fa
    from pytorch_stable_diffusion_tpu_torch.sampling import ddpm

    t_start = time.perf_counter()
    LAP.update(start=t_start, phase=t_start)
    # 1. device
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, check=True).stdout.split()[0]
    SFU.update(sms=torch.cuda.get_device_properties(0).multi_processor_count,
               clock_hz=float(clock) * 1e6)
    print(f"{SFU['sms']} SMs, max SM clock {clock} MHz: exp2 floor at "
          f"{16 * SFU['sms'] * SFU['clock_hz'] / 1e12:.2f} T/s", flush=True)
    lap("1 device")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.load_all(KERNELS)
    print(f"build: {', '.join(KERNELS)} ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (_, log) in libs.items():
        kernel = ""
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = short_name(entry.group(1))
            elif "registers" in line or "spill" in line or "C7518" in line:
                print(f"  {SHORT[name]} {kernel}: {line.strip()}", flush=True)
            elif line.startswith("built"):
                print(f"  {SHORT[name]} {line.strip()}", flush=True)
    lap("2 build")

    # 3. kernels
    results = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "c2_shapes": [], "c3_shapes": [],
                      "e_shapes": [], "f_shapes": [], "g_shapes": [], "sp_shapes": []}
               for name, (src, rep) in KERNELS.items()}
    phase_k1(fa, card, results)
    lap("3 K1")
    host_cost(fa, card)
    lap("3 host cost")
    phase_k2(fa, card, results)
    lap("3 K2")
    phase_long(fa, card, results)
    lap("3 K4, K3")
    phase_k5(k5, card, results)
    lap("3 K5")

    # 4. small input against the CPU plain path
    phase_small_reference(port, attention)
    lap("4 small")

    # 5. model
    t0 = time.perf_counter()
    cfg = port.sd15_config(policy=port.BF16, attention_backend="kernel")
    models = port.build_models(cfg, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(0))
    counts = {k: param_count(m) for k, m in models.items()}
    check(counts == SD15_COUNTS, f"parameter counts {counts}")
    torch.cuda.synchronize()
    print(f"model: SD-1.5 BF16 on the card, counts {counts} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    lap("5 model")

    # 6. requests
    tok = _tokenizer()
    base = dict(uncond_prompt="", do_cfg=True, cfg_scale=7.5, sampler_name="ddpm",
                n_inference_steps=50, models=models, tokenizer=tok, config=cfg,
                device="cuda", height=512, width=512)

    def request(name, fn, *, size, steps, n_images, img2img=False, config=cfg, context=77,
                evals=None, per_eval=None):
        # one batched UNet call an evaluation serves every image of the request;
        # ``evals``: the UNet evaluations where they are not one a step (a
        # callable where only the run knows them: dpm_adaptive's iterations)
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        n_evals = evals() if callable(evals) else evals
        if n_evals is not None:
            name, steps = f"{name} ({steps} steps, {n_evals} UNet evaluations)", n_evals
        want = expected_launches(config, size, size, steps=steps, img2img=img2img,
                                 context=context)
        # ``per_eval``: a slice-C2 family's stated launches an evaluation
        # (C2_PER_EVAL); else SD-1.5's (K5_PER_EVAL, K2_PER_EVAL)
        stated = per_eval or {"K5": K5_PER_EVAL, "K2": K2_PER_EVAL}
        k5_stated = stated["K5"] * steps \
            if config.conv_backend in ("kernel", "kernel_fold") and config.quant == "none" else 0
        check(want["K5"] == k5_stated, f"{name}: derived {want['K5']} K5 launches, "
                                       f"PERF.md states {k5_stated}")
        k2_stated = stated["K2"] * steps if context >= 256 else 0
        check(want["K2"] == k2_stated, f"{name}: derived {want['K2']} K2 launches, "
                                       f"PERF.md states {k2_stated}")
        if per_eval is not None:
            check(want["K1"] == per_eval["K1"] * steps,
                  f"{name}: derived {want['K1']} K1 launches, PERF.md states "
                  f"{per_eval['K1'] * steps}")
        if size == 2048:
            stated = {k: n * steps for k, n in PER_STEP_2048.items()}
            stated.update(K2=k2_stated, K3=2 if img2img else 1, K5=k5_stated)
            check(want == stated, f"{name}: derived {want}, PERF.md states {stated}")
        images = out[0] if isinstance(out, tuple) else out
        images = images if images.ndim == 4 else images[None]
        check(images.dtype == np.uint8 and images.shape == (n_images, size, size, 3),
              f"{name}: output {images.dtype} {images.shape}")
        for im in images:
            check(im.max() > im.min(), f"{name}: constant image")
        if isinstance(out, tuple):
            check(np.isfinite(out[1]).all(), f"{name}: latents not finite")
        check(launched == want, f"{name}: launched {launched}, want {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        unit = "UNet evaluation" if n_evals is not None else "step"
        print(f"request {name}: {dt:.2f} s wall, {dt / steps:.3f} s a {unit} (wall / "
              f"{unit}s), {n_images} image(s) {size}², {steps} {unit}s, launches "
              f"{launched}, peak {peak:.2f} GiB  [{card}]", flush=True)
        return out

    main_launches = {k: 0 for k in SHORT.values()}

    def read_path():
        for k, v in launch_counts().items():
            main_launches[k] += v

    # slice A: 512²
    zero_counts()
    a, _ = request("a txt2img seed 1337",
                   lambda: port.generate(PROMPTS[0], seed=1337, return_latents=True,
                                         **base), size=512, steps=50, n_images=1)
    b, _ = request("b txt2img seed 1337 again",
                   lambda: port.generate(PROMPTS[0], seed=1337, return_latents=True,
                                         **base), size=512, steps=50, n_images=1)
    check(np.array_equal(a, b), "same seed gave a different image")
    c, _ = request("c txt2img seed 1338",
                   lambda: port.generate(PROMPTS[0], seed=1338, return_latents=True,
                                         **base), size=512, steps=50, n_images=1)
    check(not np.array_equal(a, c), "seeds 1337 and 1338 gave the same image")
    request("d img2img strength 0.8",
            lambda: port.generate(PROMPTS[0], seed=1337, input_image=a,
                                  strength=0.8, return_latents=True, **base),
            size=512, steps=50 - ddpm.start_step_for_strength(50, 0.8), n_images=1,
            img2img=True)
    batch_kw = {k: v for k, v in base.items() if k != "uncond_prompt"}
    e = request("e generate_images x4",
                lambda: port.generate_images(PROMPTS, uncond_prompts="", seed=1337,
                                             **batch_kw), size=512, steps=50, n_images=4)
    read_path()
    print(f"requests: b == a bit-identical; c != a; e[0] vs a PSNR "
          f"{psnr(e[0].astype(np.float32), a.astype(np.float32)):.1f} dB "
          f"(same seed, batch 4 vs 1)", flush=True)
    lap("6 A")

    # slice C1: 2048², and the VAE on K3 at 512²
    zero_counts()
    big = dict(base, height=2048, width=2048, n_inference_steps=4)
    request("f txt2img 2048² 4 steps",
            lambda: port.generate(PROMPTS[1], seed=7, return_latents=True, **big),
            size=2048, steps=4, n_images=1)
    upscaled = np.repeat(np.repeat(a, 4, axis=0), 4, axis=1)
    request("g hires pass 2048² img2img strength 0.5, encode_tile/decode_tile 64",
            lambda: port.generate(PROMPTS[0], seed=1337, input_image=upscaled,
                                  strength=0.5, encode_tile=64, decode_tile=64,
                                  return_latents=True, **big),
            size=2048, steps=4 - ddpm.start_step_for_strength(4, 0.5), n_images=1,
            img2img=True)
    cfg_vae = dataclasses.replace(cfg, vae_attention_backend="kernel")
    request("h img2img 512² strength 0.8, VAE on K3",
            lambda: port.generate(PROMPTS[0], seed=1337, input_image=a, strength=0.8,
                                  return_latents=True, **dict(base, config=cfg_vae)),
            size=512, steps=50 - ddpm.start_step_for_strength(50, 0.8), n_images=1,
            img2img=True, config=cfg_vae)
    before = launch_counts()
    try:
        port.generate(PROMPTS[0], seed=1, **dict(base, height=4096, width=4096))
    except ValueError as err:
        check(launch_counts() == before, "i 4096² request launched kernels")
        print(f"request i 4096²: ValueError, as in the JAX package: {err}", flush=True)
    else:
        check(False, "i 4096² request did not raise ValueError")
    read_path()
    lap("6 C1")

    # slice H1: the conv_backend tiers at 512², 20 steps (enough to compare
    # the tiers), each against the plain tier's request of the same seed
    zero_counts()
    tier = {name: dataclasses.replace(cfg, conv_backend=name)
            for name in ("plain", "kernel", "fold", "kernel_fold")}
    h1 = dict(base, n_inference_steps=20)
    h1_batch = dict(batch_kw, n_inference_steps=20)
    txt = {}
    for label, name in (("j0", "plain"), ("j", "kernel"), ("k", "fold"), ("l", "kernel_fold"),
                        ("l'", "kernel_fold")):
        txt[label], _ = request(
            f"{label} txt2img seed 1337, conv_backend={name}",
            lambda: port.generate(PROMPTS[0], seed=1337, return_latents=True,
                                  **dict(h1, config=tier[name])),
            size=512, steps=20, n_images=1, config=tier[name])
    check(np.array_equal(txt["l"], txt["l'"]), "kernel_fold: same seed gave a different image")
    batch = {}
    for label, name in (("m0", "plain"), ("m", "kernel_fold"), ("o", "kernel"), ("p", "fold")):
        batch[label] = request(
            f"{label} generate_images x4, conv_backend={name}",
            lambda: port.generate_images(PROMPTS, uncond_prompts="", seed=1337,
                                         **dict(h1_batch, config=tier[name])),
            size=512, steps=20, n_images=4, config=tier[name])
    request("n img2img strength 0.8, conv_backend=kernel",
            lambda: port.generate(PROMPTS[0], seed=1337, input_image=a, strength=0.8,
                                  return_latents=True, **dict(h1, config=tier["kernel"])),
            size=512, steps=20 - ddpm.start_step_for_strength(20, 0.8), n_images=1,
            img2img=True, config=tier["kernel"])
    read_path()
    print("requests (not gated): PSNR against the plain tier (j0) / (m0) of the same seed: "
          + ", ".join(f"{k} {psnr(v.astype(np.float32), txt['j0'].astype(np.float32)):.1f} dB"
                      for k, v in txt.items() if k != "j0")
          + ", " + ", ".join(
              f"{k} {psnr(v.astype(np.float32), batch['m0'].astype(np.float32)):.1f} dB"
              for k, v in batch.items() if k != "m0")
          + "; l' == l bit-identical", flush=True)
    lap("6 H1")

    # slice D1: prompt features at 512², a 308-token context on K2, 20 steps
    zero_counts()
    long_kw = dict(base, emphasis=True, clip_skip=2, n_inference_steps=20)
    long_img, _ = request("q txt2img 4-window prompt, emphasis, BREAK, clip_skip=2",
                          lambda: port.generate(LONG_PROMPT, seed=1337, return_latents=True,
                                                **long_kw),
                          size=512, steps=20, n_images=1, context=308)
    long_prompts = [LONG_PROMPT] + [" BREAK ".join(PROMPTS[i:] + PROMPTS[:i])
                                    for i in (1, 2, 3)]
    request("r generate_images x4, long prompts",
            lambda: port.generate_images(long_prompts, uncond_prompts="", seed=1337,
                                         long_prompts=True, emphasis=True,
                                         **dict(batch_kw, n_inference_steps=20)),
            size=512, steps=20, n_images=4, context=308)
    edit, _ = request("s txt2img prompt edit [horse:fox:10] in the 4-window prompt",
                      lambda: port.generate(LONG_EDIT, seed=1337, return_latents=True,
                                            **long_kw),
                      size=512, steps=20, n_images=1, context=308)
    read_path()
    print(f"requests D1 (not gated): s vs q "
          f"{psnr(edit.astype(np.float32), long_img.astype(np.float32)):.1f} dB", flush=True)
    lap("6 D1")

    # slice B: every other sampler through its own denoise loop at 512²
    phase_slice_b(port, request, base, a, zero_counts, read_path)
    lap("6 B")
    # slice D: checkpoint files, the StableDiffusion API and the weight transforms
    d_files = phase_slice_d(port, card, request, zero_counts, read_path)
    lap("6 D")
    # slice C3: inpainting, InstructPix2Pix, LCM and hires_fix at 512²
    phase_slice_c3(port, card, models, cfg, zero_counts, read_path)
    lap("6 C3")
    # slice E: ControlNet, T2I-Adapter, IP-Adapter and reference-only at 512²
    phase_slice_e(port, card, models, cfg, zero_counts, read_path)
    lap("6 E")
    # slice F: the guidance and approximate modes at 512²
    phase_slice_f(port, card, models, cfg, zero_counts, read_path)
    lap("6 F")
    # slice G: AnimateDiff, panoramas and the upscalers
    phase_slice_g(port, card, models, cfg, zero_counts, read_path)
    lap("6 G")

    # 7. one UNet evaluation: time, device busy share, K2's share
    phase_vae(models, cfg, card)
    phase_step(models, cfg, card)
    phase_step(models, tier["kernel"], card)
    phase_step(models, cfg, card, size=512, context=77)
    phase_step(models, cfg, card, size=512, context=308)
    phase_step(models, cfg, card, size=512, context=77, batch=8)
    lap("7 VAE and steps")
    # slice F at 2048² (the fast preset) and 2560² (Hypertile)
    phase_slice_f_big(port, card, models, cfg, zero_counts, read_path)
    lap("7 F 2048², 2560²")

    # slice C2: SD-2.1, SDXL and the refiner, with the SD-1.5 models freed
    del models, base, batch_kw, long_kw
    torch.cuda.empty_cache()
    phase_small_c2(port, attention)
    lap("small C2")
    cpu, cpu_cfg = small_sd15_cpu(port)
    phase_small_c3(port, cpu, cpu_cfg)
    lap("small C3 (with the CPU models)")
    phase_small_e(port, cpu, cpu_cfg)
    lap("small E")
    phase_small_f(port, cpu, cpu_cfg)
    lap("small F")
    phase_small_g(port, cpu, cpu_cfg)
    lap("small G")
    del cpu
    free_host()
    xl, xl_cfg = phase_slice_c2(port, card, request, zero_counts, read_path)
    lap("C2")
    phase_step(xl, xl_cfg, card, size=1024, label="SDXL")
    phase_step(xl, xl_cfg, card, size=1024, context=308, label="SDXL")
    lap("C2 steps")
    # slice C3 on SDXL: 9-channel inpainting and LCM at 1024²
    phase_slice_c3_xl(port, card, xl, xl_cfg, zero_counts, read_path)
    lap("C3 SDXL")
    # slice E on SDXL: a ControlNet, full_adapter_xl and reference attn at 1024²
    phase_slice_e_xl(port, card, xl, xl_cfg, zero_counts, read_path)
    lap("E SDXL")
    # slice F on SDXL: PAG, FreeU and Hypertile at 1024²
    phase_slice_f_xl(port, card, xl, xl_cfg, zero_counts, read_path)
    lap("F SDXL")
    del xl
    free_host()
    torch.cuda.empty_cache()
    # slice H2: the int8 tiers, DP/TP over NCCL, the CLI and device_trace
    phase_slice_h2(port, card, request, zero_counts, read_path)
    lap("H2")
    # slice H3b: the exported program (utils/aot.py) at 512², K1, K3 and K5 inside it
    h3b = phase_slice_h3b(port, card, zero_counts, read_path)
    lap("H3b")
    # slice I: the JAX quick start, MIXED and the serving loop on H3b's artifact
    phase_slice_i(port, card, request, zero_counts, read_path, d_files, h3b)
    lap("I")
    del h3b
    d_files["dir"].cleanup()
    torch.cuda.empty_cache()
    # slice H3a: sequence parallelism, two gloo ranks on the one card
    phase_slice_h3a(port, card, zero_counts, read_path, main_launches)
    lap("H3a")
    for name, short in SHORT.items():
        results[name]["launches"] = main_launches[short]
        check(main_launches[short] > 0, f"{short} was not launched on the main paths")

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
