"""Time the strided pools' backward of two trees in turns, on one card.

    python -m picad_tpu_torch.tools.pool_bwd_ab --other DIR [--rounds 2] [--seed N]

DIR is another checkout of this repository (an unpacked older commit,
say).  Each round runs, in a process of its own for each tree and from
that tree's root, the tree's own `chip_smoke.check_pool_bwd` at the
train step's three strided pools (`chip_smoke.POOL_BWD_SHAPES`), bf16
then f32, timed: the kernel, the plain version, torch's atomic
`max_pool3d_with_indices_backward` and the byte bound, and the copy_
floor where the tree's check times one.  The trees run in turns (other,
this, this, other, ...) on the same card, so that a drift of its clocks
falls on both alike.  Each process's results are one JSON line; the
last line is one JSON object with every run, by tree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
RUN = """
import json, torch, chip_smoke as c
out = [c.check_pool_bwd(ch, dt, {seed}, timed=True)
       for dt in (torch.bfloat16, torch.float32) for ch in c.POOL_BWD_SHAPES]
print(json.dumps(out))
"""


def run_tree(tree: Path, seed: int) -> list:
    if not (tree / "chip_smoke.py").exists():
        raise SystemExit(f"{tree} has no chip_smoke.py")
    r = subprocess.run([sys.executable, "-c", RUN.format(seed=seed)], cwd=tree,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"{tree}: exit {r.returncode}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m picad_tpu_torch.tools.pool_bwd_ab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    trees = {"other": Path(args.other).resolve(), "this": REPO}
    runs: dict = {"other": [], "this": []}
    for i in range(args.rounds):
        for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
            res = run_tree(trees[name], args.seed)
            runs[name].append(res)
            print(json.dumps({"tree": name, "round": i, "pools": res}), flush=True)
            print(f"round {i} {name}: " + "; ".join(
                f"{c['pool']} {c['dtype']} kernel {c['kernel_ms']:.4f} torch "
                f"{c['library_ms']:.4f}" + (f" copy {c['copy_ms']:.4f}" if "copy_ms" in c else "")
                + f" bound {c['bound_ms']:.4f}" for c in res), flush=True)
    print(json.dumps({"trees": {k: str(v) for k, v in trees.items()}, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
