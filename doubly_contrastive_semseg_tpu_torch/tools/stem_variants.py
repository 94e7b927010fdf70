"""Where the tensor-core stem's time goes: ablations of its source, on the card.

    python3 -m doubly_contrastive_semseg_tpu_torch.tools.stem_variants

Builds ``csrc/stem_pool_tc.cu`` as it is and in variants made by replacing
one piece of its text (without the pool, without the next tile's patch
copies, both, with the patch staged word by word, one tile a block), and
times each at the three pyramid levels of a 2048×1024 batch of 8 (bf16),
with ``profile_stem.cuda_ms``. A variant that drops work gives wrong
output: only the unchanged kernel, the word-by-word staging and the one
tile a block are checked against the plain version. It also measures the
card's ``mma.sync.m16n8k16`` bf16 rate with a probe of independent
products, the ceiling of this kernel's design. Libraries go to a temporary
directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import _build, stem
from .profile_stem import CHECK_SHAPES, HEADLINE, cuda_ms, stem_params

_POOL = ("item < POOL_ITEMS;", "item < 0;")
_COPIES = ("if (next < ntiles && chunked) stage_patch_async",
           "if (false) stage_patch_async")
VARIANTS = {
    "as built": [],
    "no pool": [_POOL],
    "no next-patch copies": [_COPIES],
    "products and epilogue only": [_POOL, _COPIES],
    "patch word by word": [("const bool chunked = W % 8 == 0 &&",
                            "const bool chunked = false &&")],
    "one tile a block": [("const int grid = (int)(ntiles < resident ? ntiles : "
                          "(long long)resident);", "const int grid = (int)ntiles;")],
}
CHECKED = ("as built", "patch word by word", "one tile a block")

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
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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


def _compile(src: str, name: str, workdir: Path) -> ctypes.CDLL:
    cu, so = workdir / f"{name}.cu", workdir / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def mma_rate(workdir: Path) -> float:
    """TFLOP/s of 8 warps × 16 independent m16n8k16 products on 8 blocks an SM."""
    lib = _compile(_PROBE, "probe", workdir)
    blocks, iters = 8 * torch.cuda.get_device_properties(0).multi_processor_count, 2000
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(lambda: lib.run_probe(ctypes.c_void_p(out.data_ptr()), blocks, iters,
                                       ctypes.c_void_p(stream)), iters=5)
    return blocks * 8 * iters * 16 * (2 * 16 * 8 * 16) / ms / 1e9


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    weight, scale, shift = stem_params(gen, dev)
    w_k = stem.stem_weight_fragments(stem.pack_stem_weight(weight))
    xs = [torch.randn(*CHECK_SHAPES[lv], 3, generator=gen).to(dev, torch.bfloat16)
          for lv in range(HEADLINE)]
    refs = [stem.stem_pool_reference(x, weight, scale, shift).float() for x in xs]
    source = (_build.CSRC / "stem_pool_tc.cu").read_text()
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        print(f"mma.sync.m16n8k16 bf16 probe: {mma_rate(workdir):.1f} TFLOP/s", flush=True)
        for i, (name, edits) in enumerate(VARIANTS.items()):
            src = source
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
                src = src.replace(old, new)
            fn = _compile(src, f"v{i}", workdir).dcss_stem_pool_tc
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            times, errs = [], []
            for x, ref in zip(xs, refs):
                out = torch.empty(ref.shape, dtype=torch.bfloat16, device=dev)

                def call():
                    status = fn(x.data_ptr(), w_k.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                out.data_ptr(), *x.shape[:3], stream)
                    if status != 0:
                        raise RuntimeError(f"variant {name!r}: CUDA error {status}")

                call()
                torch.cuda.synchronize()
                errs.append((out.float() - ref).abs().max().item() / ref.abs().max().item())
                times.append(cuda_ms(call))
            if name in CHECKED and max(errs) > 2e-2:
                raise RuntimeError(f"variant {name!r} disagrees: {errs}")
            print(f"  {name:28s} levels {', '.join(f'{t:.4f}' for t in times)} ms, "
                  f"sum {sum(times):.4f} ms" + (f"; max err {max(errs):.1e} x max|ref|"
                                                if name in CHECKED else ""), flush=True)


if __name__ == "__main__":
    main()
