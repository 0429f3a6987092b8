"""Where the paged-attention kernel's time goes, on the card.

    python -m dynamo_tpu_torch.ops.profile_paged_attention [--trace]

Run from the repository root (it takes its inputs from chip_smoke.py's
``make_case``). For chip_smoke.py's phase-3 shapes, and for cases that
isolate fixed costs, it prints each call's CUDA-event time (L2 flushed
first, as chip_smoke.py times it) and the device time of the split and
merge kernels from torch.profiler. ``--trace`` also builds a copy of the
source with a ``%globaltimer`` stamp at each phase of one block (start,
row set up, pages listed, each tile landed, warps' states merged, end) and
prints those phase times for the longest row's first two chunks, cold (L2
flushed) and warm. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

import chip_smoke as cs
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import paged_attention as pa

HIST = [0, 1, 15, 16, 17, 300, 1024, 2047]

# Stamps inserted into a copy of the split kernel: (anchor text, stamp).
_TRACE_HEAD = '''
__device__ unsigned long long dtpu_trace[64];
#define TRACE(i) do { if (TR) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_)); dtpu_trace[(i)] = t_; } } while (0)
'''
_TRACE_POINTS = [
    ("namespace {\n", "namespace {\n" + _TRACE_HEAD),
    ("  const int b = blockIdx.z;\n",
     "  const int b = blockIdx.z;\n  const bool TR = threadIdx.x == 0 && blockIdx.x == TRACE_SPLIT && "
     "blockIdx.y == 0 && blockIdx.z == gridDim.z - 1;\n  TRACE(0);\n"),
    ("  const Row row = row_setup(p, b, len_s, anc_s);\n  const int chunk",
     "  const Row row = row_setup(p, b, len_s, anc_s);\n  TRACE(1);\n  const int chunk"),
    ("  __syncthreads();\n\n  const int ntiles", "  __syncthreads();\n  TRACE(2);\n\n  const int ntiles"),
    ("      __syncthreads();  // tile `it` landed for all; everyone is done with it-1\n",
     "      __syncthreads();  // tile `it` landed for all; everyone is done with it-1\n"
     "      if (it < 40) TRACE(3 + it);\n"),
    ("    __syncthreads();  // the ring is reused for the warps' merge\n",
     "    __syncthreads();  // the ring is reused for the warps' merge\n    TRACE(50);\n"),
    ("  } else {\n    // f32 path", "    TRACE(51);\n  } else {\n    // f32 path"),
]
_TRACE_READ = '''
extern "C" int dtpu_trace_read(unsigned long long* h) {
  return cudaMemcpyFromSymbol(h, dtpu_trace, sizeof(unsigned long long) * 64);
}
'''


def _cases(dev):
    def case(mode, qdt, rows, **kw):
        return cs.make_case(mode, qdt, False, 1, dev, rows, **kw)["args"]
    return [
        ("decode_bfloat16", case("decode", "bfloat16", HIST)),
        ("decode_bfloat16_burst", case("decode", "bfloat16", cs.BURST_HIST)),
        ("linear_bfloat16", case("linear", "bfloat16", HIST)),
        ("decode_float32", case("decode", "float32", HIST)),
        ("one_row_2047", case("decode", "bfloat16", [2047])),
        ("one_row_100_of_8", case("decode", "bfloat16", [0] * 7 + [100])),
        ("short_rows_wide_table", case("decode", "bfloat16", list(range(1, 9)), width=128)),
    ]


def kernel_times(dev, flush, runs=20):
    from torch.profiler import ProfilerActivity, profile

    for name, args in _cases(dev):
        call = lambda: pa.paged_spec_attention(*args)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                flush.zero_()
                call()
            torch.cuda.synchronize()
        parts = {("merge" if "merge" in e.key else "split"): e.self_device_time_total / e.count
                 for e in prof.key_averages() if "paged_attention" in e.key}
        ms = cs.time_ms(call, flush)
        print(f"{name}: call {ms * 1e3:.1f} us (CUDA events); device: "
              + ", ".join(f"{k} kernel {v:.1f} us" for k, v in sorted(parts.items())), flush=True)


def phase_trace(dev, flush):
    src = (_build.CSRC / "paged_attention.cu").read_text()
    for anchor, stamped in _TRACE_POINTS:
        if anchor not in src:
            raise RuntimeError(f"trace anchor not found in the kernel source: {anchor!r}")
        src = src.replace(anchor, stamped, 1)
    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for split in (0, 1):
        cu = out / f"paged_attention_trace{split}.cu"
        so = out / f"libpaged_attention_trace{split}.so"
        cu.write_text(src.replace("TRACE_SPLIT", str(split)) + _TRACE_READ)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.dtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dtpu_cuda_error_string.restype = ctypes.c_char_p
        libs[split] = lib
    names = {0: "start", 1: "row set up", 2: "pages listed", 50: "warps merged", 51: "end"}
    buf = (ctypes.c_ulonglong * 64)()
    plain = _build.library("paged_attention")
    cases = dict(_cases(dev))
    try:
        for name, split in (("decode_bfloat16", 0), ("decode_bfloat16", 1),
                            ("one_row_100_of_8", 0), ("linear_bfloat16", 0)):
            _build._libs["paged_attention"] = libs[split]
            for cold in (True, False):
                for _ in range(3):
                    if cold:
                        flush.zero_()
                    pa.paged_spec_attention(*cases[name])
                torch.cuda.synchronize()
                libs[split].dtpu_trace_read(buf)
                t = list(buf)
                marks = [(i, (t[i] - t[0]) / 1e3) for i in [*range(43), 50, 51]
                         if t[i] >= t[0] and t[i] - t[0] < 10**9]
                print(f"trace {name}, last row, chunk {split}, {'cold' if cold else 'warm'}: "
                      + ", ".join(f"{names.get(i, f'tile {i - 3} landed')} {us:.2f}"
                                  for i, us in marks) + " us", flush=True)
    finally:
        _build._libs["paged_attention"] = plain


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true", help="also stamp one block's phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paged_attention needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    _build.build_all()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    x = torch.zeros(16, device=dev)
    print(f"timing floor (one tiny elementwise op, CUDA events): "
          f"{cs.time_ms(lambda: x.add_(1), flush) * 1e3:.1f} us", flush=True)
    kernel_times(dev, flush)
    if args.trace:
        phase_trace(dev, flush)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
