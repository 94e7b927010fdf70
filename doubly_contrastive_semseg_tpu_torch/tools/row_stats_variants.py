"""Where the two-pass row-stats kernel's (K3) time goes: ablations of its
source, on the card.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.row_stats_variants

Builds ``csrc/row_stats.cu`` as it is and in variants made by replacing one
piece of its text, and times each launch of a call (pass A, reduce A, pass
B, reduce B) at N = 8192 and 16384, D = 128, ``neg_mode``, with
``profile_stem.cuda_ms``. The full square (every ordered tile pair read by
its rows only: twice the products) is checked against the plain version
beside the unchanged kernel; a variant that drops work gives wrong output
and is not. It also
measures the card's ``mma.sync.m16n8k8`` TF32 rate with a probe of
independent products, the ceiling of this kernel's design. Libraries go to
a temporary directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import _build, contrastive
from .profile_contrastive import contrastive_inputs, stat_errors
from .profile_stem import cuda_ms
from .stem_variants import _compile

_EARLY_OUT = ("acc[mi][ni][e] *= inv_temp;\n",
              "acc[mi][ni][e] *= inv_temp;\n"
              "  { float s_ = 0.f;\n"
              "    for (int mi = 0; mi < MT; ++mi) for (int ni = 0; ni < NT; ++ni)\n"
              "      for (int e = 0; e < 4; ++e) s_ += acc[mi][ni][e];\n"
              "    if (s_ == 1.2345e-30f) scratch[threadIdx.x] = s_;\n"
              "    return; }\n")
_ONE_PRODUCT = [("mma_tf32(acc[mi][ni], al, bh[ni]);", ""),
                ("mma_tf32(acc[mi][ni], ah, bl[ni]);", "")]
_NO_SPLIT = [("hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
              "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;",
              "hi = __float_as_uint(x);\n  lo = hi ^ 1u;")]
_FULL_SQUARE = [("tile_pair(blockIdx.x, I, J);", "I = blockIdx.x / nt;\n  J = blockIdx.x % nt;"),
                ("const bool two_sided = I != J;", "const bool two_sided = false;"),
                ("const long long blocks = nt * (nt + 1) / 2;",
                 "const long long blocks = nt * nt;")]
VARIANTS = {
    "as built": [],
    "full square": _FULL_SQUARE,
    "one product (hi.hi)": _ONE_PRODUCT,
    "no split (3 products)": _NO_SPLIT,
    "no epilogue": [_EARLY_OUT],
    "no epilogue, one product": [_EARLY_OUT, *_ONE_PRODUCT],
}
CHECKED = ("as built", "full square")

_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void probe(float* out, int iters) {
  float acc[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_probe(float* out, int blocks, int iters, void* stream) {
  probe<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate(workdir: Path) -> float:
    """TFLOP/s of 8 warps × 16 independent m16n8k8 TF32 products on 8
    blocks an SM."""
    lib = _compile(_PROBE, "probe_tf32", workdir)
    blocks, iters = 8 * torch.cuda.get_device_properties(0).multi_processor_count, 2000
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(lambda: lib.run_probe(ctypes.c_void_p(out.data_ptr()), blocks, iters,
                                       ctypes.c_void_p(stream)), iters=5)
    return blocks * 8 * iters * 16 * (2 * 16 * 8 * 8) / ms / 1e9


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    source = (_build.CSRC / "row_stats.cu").read_text()
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {n: contrastive._kernel_inputs(*contrastive_inputs(gen, dev, n, 19))
              for n in (8192, 16384)}
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        print(f"mma.sync.m16n8k8 TF32 probe: {mma_rate(workdir):.1f} TFLOP/s", flush=True)
        for i, (name, edits) in enumerate(VARIANTS.items()):
            src = source
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
                src = src.replace(old, new)
            fn = _compile(src, f"v{i}", workdir).dcss_row_stats
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                           + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 7)
            line = []
            for n, (z, labels, valid) in inputs.items():
                f32 = dict(dtype=torch.float32, device=dev)
                scratch = torch.empty(contrastive.row_stats_scratch_numel(n), **f32)
                m, nrm, s, p, c = (torch.empty(n, **f32) for _ in range(5))
                steps = ((0, (None, None), (None, None, None)), (1, (None, None), (m, nrm, None)),
                         (2, (m, nrm), (None, None, None)), (3, (None, None), (s, p, c)))

                def run(step, ins, outs):
                    status = fn(step, z.data_ptr(), labels.data_ptr(), valid.data_ptr(), n,
                                z.shape[1], 1.0 / 0.07, 1,
                                *(t.data_ptr() if t is not None else None for t in ins),
                                scratch.data_ptr(),
                                *(t.data_ptr() if t is not None else None for t in outs), stream)
                    if status != 0:
                        raise RuntimeError(f"variant {name!r}: CUDA error {status}")

                for st in steps:
                    run(*st)
                torch.cuda.synchronize()
                if name in CHECKED:
                    ref = contrastive.contrastive_row_stats_reference(z, labels, valid,
                                                                      neg_mode=True)
                    errs, ok = stat_errors((p, c, s, m, nrm), ref, valid.bool())
                    if not ok:
                        raise RuntimeError(f"{name} disagrees at N={n}: {errs}")
                times = [cuda_ms(lambda st=st: run(*st)) for st in steps]
                line.append(f"N={n}: pass A {times[0]:.4f}, reduce A {times[1]:.4f}, "
                            f"pass B {times[2]:.4f}, reduce B {times[3]:.4f}, "
                            f"sum {sum(times):.4f} ms")
            print(f"  {name:26s} " + "; ".join(line), flush=True)


if __name__ == "__main__":
    main()
