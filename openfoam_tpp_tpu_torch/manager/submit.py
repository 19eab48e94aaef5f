"""Cluster job submission: one Slurm job per case action, on one GPU.

The port's own copy of openfoam_tpp_tpu/manager/submit.py (it imports
nothing of that package): the reference's `run_case_oscar` /
`run_postprocess_oscar` scripts (main.py:350-399, 1013-1062), re-targeted
to a GPU partition. Each case is one single-card job whose body re-invokes
the port's headless command line; its checkpoint/resume logic makes
requeues free. Without `sbatch` the script is written and `submit_case`
returns False, so it can be submitted by hand on the cluster.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from openfoam_tpp_tpu_torch.utils import resources

SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --partition={partition}
#SBATCH --nodes=1
#SBATCH --ntasks=1
#SBATCH --cpus-per-task=8
#SBATCH --time={walltime}
#SBATCH --mem={mem_gb}G
#SBATCH --output={case_dir}/postProcessing/{log_prefix}.%j.out
#SBATCH --error={case_dir}/postProcessing/{log_prefix}.%j.err
{gres_line}
set -euo pipefail
cd {work_dir}

# Resume-aware: the runner picks up from the latest chk_t*.npz
# (`startFrom latestTime` parity), so requeued jobs lose nothing.
python -m openfoam_tpp_tpu_torch --headless --base-dir {base_dir} \\
    --case {case_name} --action {action}
"""


def _walltime(seconds: float) -> str:
    """Reference sizing policy (main.py:230-241): 1.5x + 1h buffer,
    capped at 24h, floored at 15 min."""
    total = min(max(seconds * 1.5 + 3600.0, 900.0), 24 * 3600.0)
    h, rem = divmod(int(total), 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


def write_job_script(
    case_dir: str,
    action: str = "run",
    partition: str = "gpu",
    gres: str | None = "gpu:1",
) -> str:
    """Write the Slurm script for a case action. Returns the script path."""
    from openfoam_tpp_tpu_torch.manager.cases import load_case_params

    case_dir = os.path.abspath(case_dir)
    base_dir = os.path.dirname(case_dir)
    case_name = os.path.basename(case_dir)
    params = load_case_params(case_dir)

    if action == "run":
        est = resources.estimate_resources(params) if "H" in params else None
        wall = _walltime(est.wall_seconds if est else 600.0)
        mem = max(int((est.memory_bytes if est else 4e9) / 1e9) + 4, 8)
    else:
        # Postprocess sizing parity (main.py:1022-1024): small + 1 h.
        wall, mem = "01:00:00", 8

    os.makedirs(os.path.join(case_dir, "postProcessing"), exist_ok=True)
    script = SLURM_TEMPLATE.format(
        job_name=f"{action}_{case_name}"[:64],
        partition=partition,
        walltime=wall,
        mem_gb=mem,
        case_dir=case_dir,
        log_prefix=f"post_{action}" if action != "run" else "run",
        gres_line=f"#SBATCH --gres={gres}" if gres else "",
        work_dir=os.getcwd(),
        base_dir=base_dir,
        case_name=case_name,
        action=action,
    )
    path = os.path.join(
        case_dir,
        "run_simulation.slurm" if action == "run"
        else f"postprocess_{action}.slurm",
    )
    with open(path, "w") as f:
        f.write(script)
    return path


def submit_case(case_dir: str, action: str = "run", partition: str = "gpu",
                gres: str | None = "gpu:1", log=print) -> bool:
    """Write + sbatch the job (prints the script path if sbatch is absent,
    so the script can be submitted manually on the cluster)."""
    path = write_job_script(case_dir, action, partition, gres)
    if shutil.which("sbatch") is None:
        log(f"  ⚠ sbatch not found — script written to {path}")
        return False
    out = subprocess.run(["sbatch", path], capture_output=True, text=True)
    if out.returncode != 0:
        log(f"  ❌ sbatch failed: {out.stderr.strip()}")
        return False
    log(f"  ✅ {out.stdout.strip()} ({path})")
    return True
