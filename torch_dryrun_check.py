"""The port's multichip dry run on four cards: ``entry.dryrun_multichip(4)``
over NCCL (a 2 × 2 (data, model) mesh, one process a card: the folds over
``data``, the wide dense kernels column-sharded over ``model``) against one
unsharded step of the same two folds on one card.

    python3 torch_dryrun_check.py          # needs 4 CUDA cards

Held, as ``tests/test_torch_parallel.py`` holds the gloo run on the CPU:

- bf16 (the dry run's default, dropout on): losses within 1e-5; every
  parameter after the step within 1e-5, or within one first-step sign flip
  (2 · lr + 1e-5) where a gradient is within a rounding of 0, the flips at
  most 0.5% of the elements;
- f32 (TF32 off in every process): losses within 1e-5; every parameter
  that the unsharded step moved by at least 0.99 lr (a gradient of at
  least ~1e-6: AdamW's first step is lr · g / (|g| + 1e-8), decay apart)
  within 1e-5. A smaller gradient is rounding, which the sharded backward
  sums in another order and that step turns into a step of another size or
  sign: those elements are held within one flip (2 · lr + 1e-5) and
  counted, at most 0.5%.

Prints the cards' name and power limit, each check's numbers and seconds,
and exits non-zero when a check fails or there are fewer than four cards.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-5
FLIPS = 0.005


def f32_rank(n_devices: int):
    """One rank of the f32 dry run, TF32 off (``launch`` calls it)."""
    from bbbp_tpu_torch import entry as en

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return en.dryrun_rank(n_devices, None, None, torch.float32)


def compare(loss, params, want_loss, want) -> dict:
    """Losses' largest gap, parameters' largest gap, and the elements
    beyond ``TOL`` of how many."""
    if set(params) != set(want):
        raise AssertionError(f"parameter names differ: {sorted(set(params) ^ set(want))}")
    flips = sum(int((np.abs(v - want[k]) > TOL).sum()) for k, v in params.items())
    return {"loss": float(np.abs(loss - want_loss).max()),
            "params": max(float(np.abs(v - want[k]).max()) for k, v in params.items()),
            "beyond": flips, "elements": sum(v.size for v in want.values())}


def first_step_held(folds: int, dtype, device, want: dict) -> dict:
    """{name: mask} of the elements that the unsharded step ``want`` moved
    by at least 0.99 lr, weight decay apart, from the dry run's init."""
    from bbbp_tpu_torch import entry as en
    from bbbp_tpu_torch.models.transformer_cnn import MultiModalRegressor

    dev = torch.device(device)
    net = MultiModalRegressor(**en.DRYRUN_MODEL, image_size=en.DRYRUN_SIDE,
                              dtype=dtype, folds=folds, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    decay = 1.0 - en.DRYRUN_LR * en.DRYRUN_WEIGHT_DECAY
    return {name: np.abs(want[name] - p.detach().cpu().numpy() * decay)
            >= 0.99 * en.DRYRUN_LR for name, p in net.named_parameters()}


def check(n_devices: int = 4, backend: str = "nccl") -> list:
    """Both dry runs against their unsharded steps; the problems found."""
    from bbbp_tpu_torch import entry as en
    from bbbp_tpu_torch.parallel.mesh import launch

    device = "cuda" if backend == "nccl" else "cpu"
    folds = en.dryrun_mesh_shape(n_devices)["data"]
    problems = []

    t0 = time.time()
    if backend == "nccl":
        dry = en.dryrun_multichip(n_devices)
        if dry["backend"] != "nccl":
            problems.append(f"dryrun_multichip ran on {dry['backend']}, not nccl")
        loss, params = dry["loss"], dry["params"]
    else:
        loss, params = launch(en.dryrun_rank, n_devices, n_devices, backend=backend)[0]
    sharded_s = time.time() - t0
    t0 = time.time()
    want_loss, want = en.dryrun_step(folds, device=device)
    bf16 = compare(loss, params, want_loss, want)
    print(f"[bf16] dryrun_multichip({n_devices}) on {backend} ({sharded_s:.1f} s, "
          f"the processes' start included) against one unsharded step of {folds} "
          f"folds on one {device} device ({time.time() - t0:.1f} s): losses "
          f"{bf16['loss']:.3g} (limit {TOL}); parameters worst {bf16['params']:.3g}, "
          f"{bf16['beyond']} of {bf16['elements']} elements beyond {TOL} (a first "
          f"AdamW step's sign at a bf16 rounding; limit {FLIPS:.1%}, each within "
          f"2 lr)", flush=True)
    if not (bf16["loss"] <= TOL and bf16["params"] <= 2 * en.DRYRUN_LR + TOL
            and bf16["beyond"] <= FLIPS * bf16["elements"]):
        problems.append(f"bf16: {bf16}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    loss, params = launch(f32_rank if backend == "nccl" else en.dryrun_rank,
                          n_devices, n_devices, *(() if backend == "nccl"
                                                  else (None, None, torch.float32)),
                          backend=backend)[0]
    sharded_s = time.time() - t0
    want_loss, want = en.dryrun_step(folds, dtype=torch.float32, device=device)
    f32 = compare(loss, params, want_loss, want)
    held = first_step_held(folds, torch.float32, device, want)
    held_err = max(float(np.abs(v - want[k])[held[k]].max(initial=0.0))
                   for k, v in params.items())
    n_held = sum(int(m.sum()) for m in held.values())
    print(f"[f32] the dry run's step on {backend} ({sharded_s:.1f} s) against one "
          f"unsharded step (TF32 off): losses {f32['loss']:.3g} (limit {TOL}); "
          f"the {n_held} of {f32['elements']} elements it moved by 0.99 lr or "
          f"more within {held_err:.3g} (limit {TOL}); all within "
          f"{f32['params']:.3g} (limit 2 lr + {TOL}), {f32['beyond']} beyond "
          f"{TOL} (limit {FLIPS:.1%})", flush=True)
    if not (f32["loss"] <= TOL and held_err <= TOL
            and f32["params"] <= 2 * en.DRYRUN_LR + TOL
            and f32["beyond"] <= FLIPS * f32["elements"]):
        problems.append(f"f32: {f32}, held elements {held_err:.3g}")
    return problems


def main() -> int:
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 4:
        print(f"torch_dryrun_check: needs 4 CUDA cards, torch sees {cards}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    problems = check(4, "nccl")
    if problems:
        print("torch_dryrun_check: FAILED: " + " | ".join(problems), file=sys.stderr)
        return 1
    print("torch_dryrun_check: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
