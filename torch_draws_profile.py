#!/usr/bin/env python3
"""K9 (``forest_draws``) timed on one CUDA card, beside an earlier build of
its source where one is given.

    python3 torch_draws_profile.py [--earlier FILE.cu] [--out FILE]

At L = 1 lane (n = 7,809 rows: one fit of the screening model), 15 and 255
lanes (n = 8,162: a lane group of the classification search), each stream
(the subsample's uniforms, the columns' uniforms at F = 30, rf's Poisson(1)
counts): device ms a call from CUDA graphs (``timing.device_ms``) and the
bound (``timing.forest_draws_bound``). ``--earlier`` builds an earlier
``csrc/draws.cu`` (the form that drew one draw a thread: ``git show
09360ce:bbbp_tpu_torch/csrc/draws.cu``) as a library of its own, with the
same C entry, and times it and the tree's in turns (earlier, tree, tree,
earlier) on the same inputs, both held bit-equal to the plain version.
Also the SASS of the built library (``cuobjdump``): for K9's two kernels and
the fused oblivious split search, registers, local memory and the
instruction mix, with its instructions of the integer ALU pipe and of the
FMA pipe counted (K9's bound counts its work on both). Writes JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter

SHAPES = ((1, 7809), (15, 8162), (255, 8162))
F = 30


def earlier_draws(source: str):
    """The earlier source as a library of its own: its ``bbbp_forest_draws``
    with the tree's argument types."""
    from bbbp_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "draws_earlier.so")
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [source, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    lib.bbbp_forest_draws.restype = ctypes.c_int
    lib.bbbp_forest_draws.argtypes = _build.kernels_lib().bbbp_forest_draws.argtypes
    return lib


CENSUS = ("draws_kernel", "oblivious_splits_kernel")
# the opcodes that issue on the integer ALU pipe and on the FMA pipe (an
# IMAD takes the adds the compiler moves there)
ALU_PIPE = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IABS", "FSETP")
FMA_PIPE = ("IMAD", "FFMA", "FMUL", "FADD")


def sass_census(library: str) -> dict:
    """Per kernel of ``CENSUS`` in ``library``: ``cuobjdump -res-usage``'s
    line and the count of each SASS opcode (its first dotted part)."""
    from bbbp_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    usage = subprocess.run([cuobjdump, "-res-usage", library], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        if not any(k in name for k in CENSUS):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", part)
        mix = Counter(op.split(".")[0] for op in ops)
        line = next((usage[i + 1].strip() for i, u in enumerate(usage[:-1])
                     if name in u), "")
        out[name] = {"resources": line, "instructions": len(ops),
                     "local_memory_ops": mix.get("LDL", 0) + mix.get("STL", 0),
                     "alu_pipe": sum(mix.get(k, 0) for k in ALU_PIPE),
                     "fma_pipe": sum(mix.get(k, 0) for k in FMA_PIPE),
                     "mix": dict(mix.most_common())}
    return out


def profile(earlier_source):
    import torch

    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.timing import device_ms, forest_draws_bound

    cuda = torch.device("cuda")
    old = earlier_draws(earlier_source) if earlier_source else None
    tree = torch.tensor([7], device=cuda)
    out = []
    for lanes, n in SHAPES:
        seeds = torch.tensor([t * 131 + k for t in range(-(-lanes // 5))
                              for k in range(5)][:lanes])
        seeds_d = seeds.to(cuda)
        for stream, size in (("subsample", n), ("columns", F), ("poisson", n)):
            thresholds = tr.poisson_thresholds() if stream == "poisson" else ()
            table = ((ctypes.c_uint32 * len(thresholds))(*thresholds)
                     if thresholds else None)

            def earlier(out_):
                rc = old.bbbp_forest_draws(
                    seeds_d.data_ptr(), lanes, tree.data_ptr(), 0,
                    tr.DRAW_STREAMS[stream], size, table, len(thresholds),
                    out_.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"earlier forest_draws: cudaError {rc}")

            want = tr.forest_draws_reference(seeds, 7, stream, size)
            got = tr.forest_draws(seeds_d, tree, stream, size)
            row = {"lanes": lanes, "stream": stream, "size": size,
                   "bit_equal": bool(torch.equal(got.cpu(), want)),
                   "bound": forest_draws_bound(lanes, size, stream == "poisson")}
            if old is None:
                row["ms"] = [device_ms(lambda: tr.forest_draws(seeds_d, tree, stream, size))]
            else:
                buf = torch.empty(lanes, size, device=cuda)
                earlier(buf)
                row["earlier_bit_equal"] = bool(torch.equal(buf.cpu(), want))
                row["ms"], row["earlier_ms"] = [], []
                for form in ("earlier", "tree", "tree", "earlier"):
                    if form == "tree":
                        row["ms"].append(device_ms(
                            lambda: tr.forest_draws(seeds_d, tree, stream, size)))
                    else:
                        row["earlier_ms"].append(device_ms(lambda: earlier(buf)))
            out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", default=None, help="an earlier csrc/draws.cu")
    ap.add_argument("--out", default="chiprun_out/draws_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_draws_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch._build import build_kernels
    from bbbp_tpu_torch.timing import nvidia_smi

    result = {"card": nvidia_smi(), "earlier": args.earlier,
              "draws": profile(args.earlier), "sass": sass_census(build_kernels())}
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0 if all(r["bit_equal"] and r.get("earlier_bit_equal", True)
                    for r in result["draws"]) else 1


if __name__ == "__main__":
    sys.exit(main())
