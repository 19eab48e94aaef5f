"""Linear potential-flow theory for orbitally shaken cylinders.

The port's own copy of openfoam_tpp_tpu/utils/potential_flow.py (numpy
and scipy on the host; it imports nothing of that package): the same
numbers, CSV bytes and frames.

The analytic oracle used to validate simulated wave heights — capability
parity with the reference's utils/potential_flow.py (Alpresa-style linear
theory). Physics (standard results for the m=1 sloshing modes of a
cylinder of radius R with liquid depth d, orbital forcing radius a at
angular frequency ω):

  * mode wavenumbers   λ_n = ε_n / R with ε_n the zeros of J₁′
  * natural freqs      ω_n² = g λ_n tanh(λ_n d)
  * Froude number      F = a ω² / g
  * wall amplitude     A_PT = 2 R F (1 + Σ_n [(ε_n² − 1)(ω_n²/ω² − 1)]⁻¹)
  * wall elevation     ζ_w(θ, t) = A_PT cos(ωt − θ)
  * surface shape      ζ(r, θ, t) ≈ ζ_w(θ, t) · J₁(ε₁ r/R) / J₁(ε₁)

`root_mode="reference"` reproduces the reference's Bessel-root table
(5 tabulated J₁′ zeros + (n+1.25)π asymptote, potential_flow.py:47-57)
so A_PT matches its shipped outputs to printout precision, e.g.
A_PT = 3.146940e-02 m for the case_…f1.88_d20.0_m0.009 production case
(post_flow.117896.out). `root_mode="exact"` uses scipy's jnp_zeros.
"""

from __future__ import annotations

import os

import numpy as np

G = 9.81

# First zeros of J1' (standard tables, e.g. Abramowitz & Stegun 9.5).
_J1P_ZEROS_TABLE = np.array([1.8412, 5.3314, 8.5363, 11.7060, 14.8636])


def bessel_j1prime_zeros(n_modes: int, root_mode: str = "reference"):
    """ε_n, the first `n_modes` zeros of J₁′."""
    if root_mode == "exact":
        from scipy.special import jnp_zeros

        return jnp_zeros(1, n_modes)
    eps = np.empty(n_modes)
    k = min(n_modes, len(_J1P_ZEROS_TABLE))
    eps[:k] = _J1P_ZEROS_TABLE[:k]
    for n in range(k, n_modes):
        # Large-order asymptote used by the reference (potential_flow.py:66).
        eps[n] = (n + 1.25) * np.pi
    return eps


def natural_frequencies(R: float, d: float, n_modes: int = 30,
                        root_mode: str = "reference"):
    """ω_n = sqrt(g λ_n tanh(λ_n d)) for the m=1 modes. Returns (ω_n, ε_n)."""
    eps = bessel_j1prime_zeros(n_modes, root_mode)
    lam = eps / R
    omega_n = np.sqrt(G * lam * np.tanh(lam * d))
    return omega_n, eps


def wall_amplitude(R: float, a: float, omega: float, d: float,
                   n_modes: int = 30, root_mode: str = "reference",
                   resonance_tol: float = 1e-6):
    """Linear-theory wall amplitude A_PT and Froude number F.

    Near-resonant modes (|ω_n²/ω² − 1| < tol) are skipped, mirroring the
    reference's guard (potential_flow.py:108-110)."""
    froude = a * omega * omega / G
    omega_n, eps = natural_frequencies(R, d, n_modes, root_mode)
    ratio_sq = (omega_n / omega) ** 2
    denom = (eps ** 2 - 1.0) * (ratio_sq - 1.0)
    keep = np.abs(ratio_sq - 1.0) >= resonance_tol
    series = np.sum(np.where(keep, 1.0 / np.where(keep, denom, 1.0), 0.0))
    a_pt = 2.0 * R * froude * (1.0 + series)
    return a_pt, froude


def wall_elevation(theta, t, a_pt: float, omega: float):
    """ζ_w(θ, t) = A_PT cos(ωt − θ) — a wave rotating with the orbit."""
    theta = np.asarray(theta)
    t = np.asarray(t)
    return a_pt * np.cos(omega * t - theta)


def surface_shape(r, theta, t, a_pt, omega, R, n_modes: int = 1,
                  root_mode: str = "reference"):
    """First-mode radial reconstruction ζ(r,θ,t) = ζ_w(θ,t)·J₁(ε₁r/R)/J₁(ε₁)."""
    from scipy.special import jn

    eps1 = bessel_j1prime_zeros(1, root_mode)[0]
    radial = jn(1, eps1 * np.asarray(r) / R) / jn(1, eps1)
    return wall_elevation(theta, t, a_pt, omega) * radial


def predict(R: float, a: float, freq: float, d: float, n_modes: int = 30,
            root_mode: str = "reference") -> dict:
    """Full prediction summary for a case (print_summary-compatible keys)."""
    omega = 2.0 * np.pi * freq
    a_pt, froude = wall_amplitude(R, a, omega, d, n_modes, root_mode)
    return {
        "A_PT": a_pt,
        "Delta_h_PT": 2.0 * a_pt,
        "F": froude,
        "R": R,
        "a": a,
        "omega": omega,
        "freq": freq,
        "d": d,
        "n_modes": n_modes,
    }


def generate_wall_elevation_csv(
    case_dir: str,
    R: float,
    a: float,
    freq: float,
    d: float,
    duration: float = 10.0,
    dt: float = 0.01,
    n_theta: int = 64,
    n_modes: int = 30,
    output_file: str | None = None,
    root_mode: str = "reference",
):
    """Write the (time, theta, zeta_wall) CSV with the reference's exact
    schema and formatting (potential_flow.py:178-186):
    time %.6f, theta %.6f, zeta %.8e; θ in [0, 2π) with n_theta bins."""
    if output_file is None:
        output_file = "potential_flow_wall.csv"
        if os.path.isdir(case_dir):
            output_file = os.path.join(case_dir, output_file)

    summary = predict(R, a, freq, d, n_modes, root_mode)
    summary["output_file"] = output_file
    omega, a_pt = summary["omega"], summary["A_PT"]

    times = np.arange(0.0, duration + dt, dt)
    thetas = np.linspace(0.0, 2.0 * np.pi, n_theta, endpoint=False)
    zeta = a_pt * np.cos(omega * times[:, None] - thetas[None, :])

    lines = ["time,theta,zeta_wall"]
    for i, t in enumerate(times):
        for j, th in enumerate(thetas):
            lines.append(f"{t:.6f},{th:.6f},{zeta[i, j]:.8e}")
    with open(output_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    return output_file, summary


def _save_frames(frames, out_path: str, fps: int):
    """Encode frames: MP4 via imageio/ffmpeg when available, else MJPEG
    AVI (post/avi.py, codec-free), else PNG frames."""
    try:
        from openfoam_tpp_tpu_torch.post.avi import save_video

        return save_video(out_path, frames, fps=fps)
    except Exception:
        base = os.path.splitext(out_path)[0]
        import matplotlib.pyplot as plt

        for i, fr in enumerate(frames):
            plt.imsave(f"{base}_frame_{i:04d}.png", fr)
        return base + "_frame_*.png"


def generate_3d_animation(
    out_path: str,
    R: float,
    a: float,
    freq: float,
    d: float,
    duration: float = 4.0,
    fps: int = 20,
    n_r: int = 24,
    n_theta: int = 48,
    root_mode: str = "reference",
):
    """3-D rotating-wave surface animation from linear theory —
    capability parity with the reference's `generate_3d_animation`
    (utils/potential_flow.py:238-350): reconstructs
    Z(r, θ, t) = ζ_w(θ, t) · J₁(ε₁ r/R)/J₁(ε₁) on a polar grid and renders
    a matplotlib surface per frame."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    summary = predict(R, a, freq, d, root_mode=root_mode)
    omega, a_pt = summary["omega"], summary["A_PT"]

    r = np.linspace(0.0, R, n_r)
    th = np.linspace(0.0, 2.0 * np.pi, n_theta)
    RR, TT = np.meshgrid(r, th, indexing="ij")
    X, Y = RR * np.cos(TT), RR * np.sin(TT)

    frames = []
    times = np.arange(0.0, duration, 1.0 / fps)
    for t in times:
        Z = surface_shape(RR, TT, t, a_pt, omega, R, root_mode=root_mode)
        fig = plt.figure(figsize=(6, 5), dpi=100)
        ax = fig.add_subplot(111, projection="3d")
        ax.plot_surface(X, Y, Z, cmap="viridis", vmin=-a_pt, vmax=a_pt,
                        linewidth=0, antialiased=False)
        ax.set_zlim(-2 * a_pt if a_pt > 0 else -1, 2 * a_pt if a_pt > 0 else 1)
        ax.set_title(f"Potential flow surface  t = {t:.2f} s")
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy())
        plt.close(fig)
    return _save_frames(frames, out_path, fps), summary


def generate_dashboard_animation(
    out_path: str,
    R: float,
    a: float,
    freq: float,
    d: float,
    duration: float = 4.0,
    fps: int = 20,
    root_mode: str = "reference",
):
    """Dashboard animation — parity with the reference's
    `generate_dashboard_animation` (utils/potential_flow.py:352-402):
    polar wall-elevation snapshot plus wave-probe traces at θ = 0°, 90°,
    180° (potential_flow.py:391)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    summary = predict(R, a, freq, d, root_mode=root_mode)
    omega, a_pt = summary["omega"], summary["A_PT"]

    theta = np.linspace(0.0, 2.0 * np.pi, 128)
    probes = [0.0, np.pi / 2.0, np.pi]
    times = np.arange(0.0, duration, 1.0 / fps)
    traces = [wall_elevation(p, times, a_pt, omega) for p in probes]

    frames = []
    for i, t in enumerate(times):
        fig, (ax1, ax2) = plt.subplots(
            1, 2, figsize=(9, 4), dpi=100,
            subplot_kw={}, gridspec_kw={"width_ratios": [1, 1.4]}
        )
        ax1.plot(theta, wall_elevation(theta, t, a_pt, omega))
        ax1.set_xlabel("theta [rad]")
        ax1.set_ylabel("zeta_wall [m]")
        ax1.set_ylim(-1.5 * a_pt if a_pt > 0 else -1,
                     1.5 * a_pt if a_pt > 0 else 1)
        ax1.set_title(f"Wall elevation  t = {t:.2f} s")
        for p, tr, lbl in zip(probes, traces, ("0°", "90°", "180°")):
            ax2.plot(times[: i + 1], tr[: i + 1], label=f"probe {lbl}")
        ax2.set_xlim(0, duration)
        ax2.set_ylim(-1.5 * a_pt if a_pt > 0 else -1,
                     1.5 * a_pt if a_pt > 0 else 1)
        ax2.set_xlabel("t [s]")
        ax2.legend(loc="upper right", fontsize=8)
        ax2.set_title("Wave probes")
        fig.tight_layout()
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy())
        plt.close(fig)
    return _save_frames(frames, out_path, fps), summary


def print_summary(summary: dict):
    """Console summary with the reference's exact layout
    (potential_flow.py:205-222; verifiable against post_flow.117896.out)."""
    bar, dash = "=" * 60, "-" * 60
    print("\n" + bar)
    print("  Potential Flow Theory Prediction")
    print(bar)
    print(f"  Cylinder Radius (R):       {summary['R']:.4f} m")
    print(f"  Orbital Radius (a):        {summary['a']:.4f} m")
    print(f"  Forcing Frequency (f):     {summary['freq']:.4f} Hz")
    print(f"  Angular Frequency (ω):     {summary['omega']:.4f} rad/s")
    print(f"  Liquid Depth (d):          {summary['d']:.4f} m")
    print(f"  Froude Number (F):         {summary['F']:.6f}")
    print(dash)
    print(f"  Wall Amplitude (A_PT):     {summary['A_PT']:.6e} m")
    print(f"  Crest-to-Trough (Δh_PT):   {summary['Delta_h_PT']:.6e} m")
    print(dash)
    print(f"  Modes Used:                {summary['n_modes']}")
    print(f"  Output File:               {summary.get('output_file', '-')}")
    print(bar + "\n")


def _main(argv=None):
    """Standalone CLI — parity with the reference module's own entry point
    (utils/potential_flow.py:431-456)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Linear potential-flow prediction for an orbitally "
                    "shaken cylinder")
    ap.add_argument("--R", type=float, required=True, help="cylinder radius [m]")
    ap.add_argument("--a", type=float, required=True, help="orbital radius [m]")
    ap.add_argument("--freq", type=float, required=True, help="frequency [Hz]")
    ap.add_argument("--depth", type=float, required=True, help="liquid depth [m]")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--animate", action="store_true",
                    help="also render 3D + dashboard animations")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    path, summary = generate_wall_elevation_csv(
        args.out, R=args.R, a=args.a, freq=args.freq, d=args.depth,
        duration=args.duration)
    print_summary(summary)
    if args.animate:
        p3, _ = generate_3d_animation(
            os.path.join(args.out, "potential_flow_3d.mp4"),
            args.R, args.a, args.freq, args.depth)
        pd, _ = generate_dashboard_animation(
            os.path.join(args.out, "potential_flow_dashboard.mp4"),
            args.R, args.a, args.freq, args.depth)
        print(f"  animations: {p3}  {pd}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
