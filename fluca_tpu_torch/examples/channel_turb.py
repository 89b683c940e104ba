"""Turbulent channel at Re_tau = 180, wall-clustered (counterpart of
examples/channel_turb.py): run long enough to show (a) the perturbation
energy does not decay to laminar, (b) the mean profile is qualitatively
log-law, (c) u_tau comes back within ~10 % of the forcing balance (rho
u_tau^2 = f_x delta, so u_tau = 1 at statistical stationarity).

Box: (4, 2, 2) delta = 720 x 360 wall units streamwise / spanwise, the
minimal-flow-unit regime (Jimenez & Moin 1991: sustained turbulence needs
Lx+ >~ 250-350, Lz+ >~ 100). Grid N^3 with tanh stretch 2.0 in y (at N
128: dx+ 5.6, dz+ 2.8, first cell y+ ~ 0.2). Initial condition "rolls"
(large-scale rolls and streaks; white noise is annihilated viscously at
128^3 before it can grow); float32 production(); the bf16 preconditioner
only with --bf16 (on this anisotropic grid its V-cycle is too weak and
the mean flow decays: the reference's CHANNEL_TURB_BF16_COLLAPSED.json).

The run advances in chunks of CHUNK steps (500, as the JAX script) and
after each reads the fluctuation energy E_turb, u_tau and the profiles
(turb_stats), under three guards: DIVERGED (E not finite), COLLAPSED
(u_tau < 0.3 after t = 2: the solve returns ~zero corrections) and the
fluctuation collapse (E < 1e-4 after t = 1.5).

    python -m fluca_tpu_torch.examples.channel_turb [T_total] [dt] --out PATH
        [--N 128] [--ic rolls] [--bf16] [--device cuda]

T_total defaults to 40 and dt to 1e-3, as in the JAX script. Prints a
line per chunk and, last, one JSON line of the summary; the series,
profiles and summary go to PATH.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from fluca_tpu_torch.bench import device_info
from fluca_tpu_torch.examples._common import parser
from fluca_tpu_torch.models.channel import setup_channel_3d
from fluca_tpu_torch.ns.cnlinear import CNLinearConfig
from fluca_tpu_torch.ns.ns import check_device

RE_TAU = 180.0
L = (4.0, 2.0, 2.0)
STRETCH_Y = 2.0
PERTURB = 0.2
CHUNK = 500  # steps between readings


def _host(x) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def turb_stats(ns):
    """(E_turb, u_tau, profiles): the fluctuation kinetic energy about the
    xz-mean profile, the friction velocity from the wall gradient (both
    walls averaged), and the xz-mean profiles: mean U, the Reynolds shear
    stress <u'v'>(y) and the mean squared fluctuations. On the host in
    float64, as the JAX script's."""
    v = [_host(x) for x in ns.state["v"]]
    nu = ns.mu / ns.rho
    cy = np.asarray(ns.mesh.centers(1))
    Umean = v[0].mean(axis=(0, 2))
    Vmean = v[1].mean(axis=(0, 2))
    Wmean = v[2].mean(axis=(0, 2))
    up = v[0] - Umean[None, :, None]
    vp = v[1] - Vmean[None, :, None]
    wp = v[2] - Wmean[None, :, None]
    E = 0.5 * float((up**2 + vp**2 + wp**2).mean())
    profiles = {
        "U": Umean,
        "uv": (up * vp).mean(axis=(0, 2)),
        "uu": (up * up).mean(axis=(0, 2)),
        "vv": (vp * vp).mean(axis=(0, 2)),
        "ww": (wp * wp).mean(axis=(0, 2)),
    }
    # wall gradient from the first cell centre (no-slip walls at y = 0
    # and y = 2 delta)
    dudy_lo = Umean[0] / cy[0]
    dudy_hi = Umean[-1] / (2.0 - cy[-1])
    tau = nu * 0.5 * (dudy_lo + dudy_hi)
    u_tau = float(np.sqrt(max(tau, 0.0)))
    return E, u_tau, profiles


def setup(N, dt, ic="rolls", bf16=False, *, device="cuda"):
    """The channel of the run: N^3, stretch 2.0, float32 production()
    (the bf16 preconditioner where ``bf16``)."""
    ns = setup_channel_3d(N=(N, N, N), dt=dt, max_steps=10**9, stretch_y=STRETCH_Y,
                          perturb=PERTURB, perturb_mode=ic, dtype=torch.float32,
                          device=device)
    cfg = CNLinearConfig.production()
    if bf16:
        cfg.precond_dtype = "bfloat16"
    ns.impl.cfg = cfg
    return ns


def guard(t, E, u_tau):
    """The run's verdict after a chunk: None to go on, else why it stops."""
    if not np.isfinite(E):
        return "DIVERGED"
    if t >= 2.0 and u_tau < 0.3:
        # the forcing balance pins u_tau ~ 1; a near-zero wall gradient
        # means the solve returns ~zero corrections, not physics
        return "COLLAPSED (u_tau ~ 0): solver under-resolving"
    if t >= 1.5 and E < 1e-4:
        # the transition overshoot (E ~ 40) can push the convective CFL
        # past ~1.5, where the fixed budgets kill the fluctuations
        return "COLLAPSED (E ~ 0): fluctuations killed — transition-peak CFL too high " \
               "for the budgets?"
    return None


def run(ns, nsteps, chunk, t_stats, log=print):
    """One step, then ``nsteps // chunk`` chunks of ``chunk`` steps with
    turb_stats and the guards after each. Returns (series, accumulated
    profiles from t >= t_stats, their count, the guard that stopped the
    run or None)."""
    series, prof_acc, prof_n, stop = [], None, 0, None
    t0 = time.perf_counter()
    ns.step()
    for k in range(nsteps // chunk):
        ns.advance(chunk)
        E, u_tau, profs = turb_stats(ns)
        t = ns.t
        series.append({"t": round(float(t), 4), "E_turb": E, "u_tau": round(u_tau, 4)})
        log(f"t={t:7.3f}  E_turb={E:10.4e}  u_tau={u_tau:.4f}  ({(k + 1) * chunk + 1} "
            f"steps, {((k + 1) * chunk) / (time.perf_counter() - t0):.1f} steps/s)")
        if t >= t_stats:
            prof_acc = profs if prof_acc is None else {
                key: prof_acc[key] + profs[key] for key in profs}
            prof_n += 1
        stop = guard(t, E, u_tau)
        if stop:
            log(stop)
            break
    return series, prof_acc, prof_n, stop


def summary(ns, N, dt, T_total, series, prof_acc, prof_n):
    """The JAX script's record: the configuration, the series, u_tau at
    the end (mean of the last 10 readings), the sustained-turbulence
    verdict, the mean profile and the second-half Reynolds stresses in
    wall units."""
    profs = ({key: prof_acc[key] / max(prof_n, 1) for key in prof_acc}
             if prof_acc is not None else turb_stats(ns)[2])
    Umean = profs["U"]
    u_tau_final = (float(np.mean([s["u_tau"] for s in series[-10:]])) if len(series) >= 10
                   else series[-1]["u_tau"])
    cy = np.asarray(ns.mesh.centers(1))
    nu = ns.mu / ns.rho
    yp = cy[: N // 2] * u_tau_final / nu
    Up = Umean[: N // 2] / max(u_tau_final, 1e-12)
    # sustained: the energy of the last quarter holds the second half's
    # median band (the global maximum is the transition spike, ~50x the
    # steady level; laminarization decays E exponentially)
    Es = [s["E_turb"] for s in series]
    ref_band = float(np.median(Es[len(Es) // 2:])) if Es else 0.0
    sustained = (len(Es) > 8 and min(Es[-len(Es) // 4:]) > 0.3 * ref_band
                 and ref_band > 1e-3 and np.isfinite(Es[-1]))
    ut = max(u_tau_final, 1e-12)

    def rms(x):
        return round(float(np.sqrt(max(x, 0.0))) / ut, 4)

    return {
        "config": {"N": N, "Re_tau": RE_TAU, "dt": dt, "T_total": T_total, "L": list(L),
                   "stretch_y": STRETCH_Y, "perturb": PERTURB, "box_wall_units": [720, 360],
                   "dx_plus": round(L[0] / N * RE_TAU, 2),
                   "dz_plus": round(L[2] / N * RE_TAU, 2)},
        "series": series,
        "u_tau_final": u_tau_final,
        "u_tau_target": 1.0,
        "u_tau_rel_err": abs(u_tau_final - 1.0),
        "sustained": bool(sustained),
        "mean_profile": {"y_plus": [round(float(x), 3) for x in yp],
                         "U_plus": [round(float(x), 4) for x in Up]},
        "reynolds_stress": {
            "y": [round(float(x), 5) for x in cy],
            "uv_plus": [round(float(x) / ut**2, 5) for x in profs["uv"]],
            "urms_plus": [rms(x) for x in profs["uu"]],
            "vrms_plus": [rms(x) for x in profs["vv"]],
            "wrms_plus": [rms(x) for x in profs["ww"]],
        },
    }


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("T_total", nargs="?", type=float, default=40.0)
    ap.add_argument("dt", nargs="?", type=float, default=1e-3)
    ap.add_argument("--N", type=int, default=128, help="cells per axis (64: the minimal "
                    "channel, dx+ 11.25; 128: dx+ 5.6)")
    ap.add_argument("--ic", default="rolls", help="initial perturbation: rolls | noise")
    ap.add_argument("--bf16", action="store_true", help="the bf16 preconditioner")
    args = ap.parse_args(argv)
    if args.out is None:
        ap.error("--out PATH is required")
    dev = check_device(args.device)
    ns = setup(args.N, args.dt, args.ic, args.bf16, device=dev)
    nsteps = int(round(args.T_total / args.dt))
    t0 = time.perf_counter()
    series, prof_acc, prof_n, stop = run(ns, nsteps, CHUNK, 0.5 * args.T_total,
                                         log=lambda s: print(s, flush=True))
    wall = time.perf_counter() - t0
    out = summary(ns, args.N, args.dt, args.T_total, series, prof_acc, prof_n)
    out.update(stopped=stop, wall_s=round(wall, 1), device=device_info(dev))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("series", "mean_profile")}), flush=True)
    return 0 if stop is None else 1


if __name__ == "__main__":
    raise SystemExit(main())
