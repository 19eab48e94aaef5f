"""`forcing=` over ranks on the card, without the rest of chip_smoke.py:
the tiled sweep over x·y ranks and the geometry sweep over (case, x, y)
ranks.

    python3 scripts/port_ranks_tiled.py

Builds the kernels, then runs chip_smoke.py's phase 2 (viii) (rows 10a-c
and 11a-12d at the shapes these runs give them), phase 10 (the
one-process tiled sweep whose ms/step 12h prints beside its own) and
12h; writes the phases' stats to perf_out/port_ranks_tiled.json and
prints the card's name and power limit. About 4 minutes on an H100."""
import json, os, subprocess, sys, time
repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout
sys.path.insert(0, repo)
import chip_smoke as cs


def main():
    import torch
    from openfoam_tpp_tpu_torch.config import PhysicalProperties
    from openfoam_tpp_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    out = {}
    t0 = time.perf_counter()
    out["2viii"] = cs.phase_tiled_block_kernels(dev)
    cs.log(f"[2 viii] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # Phase 10 compares itself with phase 6's batched sweep; only its
    # printout reads these numbers.
    nan = float("nan")
    sweep = {"make_sweep_step": {k: nan for k in (
        "ms_per_step", "agg_cell_updates_per_s", "ops_per_step",
        "busy_ms_per_step")}}
    out["10"], _, _ = cs.phase_tiled(dev, PhysicalProperties(), sweep)
    cs.log(f"[10] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["12h"] = cs.phase_tiled_geom_ranks(dev, out["10"])
    cs.log(f"[12h] {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.join(repo, "perf_out"), exist_ok=True)
    with open(os.path.join(repo, "perf_out", "port_ranks_tiled.json"),
              "w") as f:
        json.dump(out, f, indent=1, default=str)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    print("ranks tiled OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
