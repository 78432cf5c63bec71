#!/usr/bin/env python3
"""Launch bounds of K5's bf16 kernel (csrc/scaled_silu_conv3x3.cu): the
source as it stands (two CTAs an SM by its registers) against the same
source built to fit three CTAs an SM (``__launch_bounds__(THREADS, 3)``), at
every distinct res-block conv shape of SD-1.5 at 512² and 2048² (CFG batch
2), and summed over the 44 convs of one UNet evaluation at each size.

    python3 k5_launch_bounds.py

Needs one CUDA card and nvcc; the variant is built into build/kernels/.
Times are the device time of the conv kernel under torch.profiler, the two
builds timed in the order base, variant, variant, base at each shape; the
two builds' outputs must agree bit for bit.
"""

import ctypes
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import k5_inputs, res_convs

BOUNDS = "__launch_bounds__(THREADS)\nconv_bf16_kernel("
VARIANT = "__launch_bounds__(THREADS, 3)\nconv_bf16_kernel("


def build_variant(build):
    src = (build.CSRC_DIR / "scaled_silu_conv3x3.cu").read_text()
    if src.count(BOUNDS) != 1:
        sys.exit("k5_launch_bounds.py: the bf16 kernel's launch bounds were not found")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "scaled_silu_conv3x3_lb3.cu"
    cu.write_text(src.replace(BOUNDS, VARIANT))
    so = build.BUILD_DIR / "libscaled_silu_conv3x3_lb3.so"
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if done.returncode != 0:
        sys.exit(f"k5_launch_bounds.py: nvcc failed:\n{done.stderr}")
    for line in done.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  variant {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def launcher(lib):
    """The bf16 kernel of ``lib`` on prepared inputs (channels_last x and
    weight, fp32 contiguous scale, shift and bias)."""
    fn = lib.sdt_scaled_silu_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, scale, shift, weight, bias):
        b, cin, h, w = x.shape
        cout = weight.shape[0]
        out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        err = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), b, h, w, cin, cout, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"k5_launch_bounds.py: launch failed ({err})")
        return out

    return run


def device_ms(fn, args, n=10):
    """Mean device ms of ``fn(*args)`` over ``n`` calls under torch.profiler,
    after one warm-up call."""
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / n


def main():
    if not torch.cuda.is_available():
        sys.exit("k5_launch_bounds.py: no CUDA device")
    import pytorch_stable_diffusion_tpu_torch as port
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import build
    from pytorch_stable_diffusion_tpu_torch.ops.cuda import conv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = {"base": launcher(build.load("scaled_silu_conv3x3")[0]),
              "3 CTAs an SM": launcher(build_variant(build))}
    cfg = port.sd15_config()
    g = torch.Generator(device="cuda").manual_seed(5)
    for size in (512, 2048):
        convs = res_convs(cfg, size, size)
        total = dict.fromkeys(builds, 0.0)
        for h, w, cin, cout in sorted(set(convs), key=lambda s: (-s[0], s[2], s[3])):
            x, gn, weight, bias, _ = k5_inputs(2, h, w, cin, cout, torch.bfloat16, g)
            scale, shift = (t.contiguous() for t in conv.fold_gn_affine(gn, x, 32))
            args = (x, scale, shift, weight, bias)
            outs = [fn(*args) for fn in builds.values()]
            if not torch.equal(*outs):
                sys.exit(f"k5_launch_bounds.py: the builds disagree at {(h, w, cin, cout)}")
            ms = dict.fromkeys(builds, 0.0)
            for name in (*builds, *reversed(builds)):
                ms[name] += device_ms(builds[name], args) / 2
            n = convs.count((h, w, cin, cout))
            for name in builds:
                total[name] += n * ms[name]
            print(f"K5 bf16 (2, {h}, {w}, {cin} -> {cout}) x{n}: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f"  [{card}]", flush=True)
            del x, gn, weight, bias, scale, shift, args, outs
        print(f"K5 bf16 {size}² UNet evaluation (44 convs): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in total.items())
              + f"  [{card}]", flush=True)


if __name__ == "__main__":
    main()
