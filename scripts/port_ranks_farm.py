"""A sweep farmed over a (case, x, y) grid of ranks and the plain step
over ranks, on the card, without the rest of chip_smoke.py.

    python3 scripts/port_ranks_farm.py

Builds the kernels, runs the card tests of the batch apply-dot (its
column window among them), then chip_smoke.py's phase 2 (vii) (rows
10a-c on the extended blocks of a farm over ranks), phases 6 and 5 (what
12g holds its runs against) and 12g; writes the phases' stats to
perf_out/port_ranks_farm.json and prints the card's name and power
limit. About 5 minutes on an H100."""
import json, os, subprocess, sys, tempfile, time
repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout
sys.path.insert(0, repo)
import chip_smoke as cs


def main():
    import torch
    from openfoam_tpp_tpu_torch.config import PhysicalProperties
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all(ptxas_verbose=True)
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    for line in logs["seven_point_batch"].splitlines():
        if "apply_dot" in line or "registers" in line:
            cs.log(f"  seven_point_batch: {line.strip()}")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q", "-x",
                        "tests/test_torch_cuda.py", "-m", "gpu", "-k",
                        "column_window or apply_dot_batch or batch_seven_point"],
                       cwd=repo, capture_output=True, text=True)
    cs.log(r.stdout[-3000:] + r.stderr[-2000:])
    cs.log(f"[card tests] rc {r.returncode} {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    out = {}
    t0 = time.perf_counter()
    out["2vii"] = cs.phase_xy_batch_kernels((12, 12, 50, cs.SWEEP_CASES), dev)
    cs.log(f"[2 vii] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, sweep = cs.phase_sweep(dev, PhysicalProperties())
    cs.log(f"[6] {time.perf_counter() - t0:.1f} s")
    geom = build_tank_geometry(**cs.FLAGSHIP)
    with tempfile.TemporaryDirectory(prefix="ranks_farm_case_") as base:
        t0 = time.perf_counter()
        _, case = cs.phase_case(geom, base)
        cs.log(f"[5] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["12g"] = cs.phase_farm_ranks(dev, sweep, case)
    cs.log(f"[12g] {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.join(repo, "perf_out"), exist_ok=True)
    with open(os.path.join(repo, "perf_out", "port_ranks_farm.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print("ranks farm OK" if r.returncode == 0 else "ranks farm: card tests FAILED")
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
