"""SP/CP capacity scaling of shard-local windowed noise synthesis
(VERDICT r3 item 7 / SURVEY.md:119).

The claim `sharded_synthesis_run` makes: ensemble CAPACITY scales
linearly with the dp mesh size at CONSTANT per-device memory, because
each device synthesizes only its own trajectories' noise from its key
slice (no cross-device noise traffic) and, with ``noise_window``,
only a (ltraj, w+1, nc) time slice of it is ever resident.

This experiment runs a WEAK-SCALING sweep on a virtual CPU mesh
(dp = 1, 2, 4, 8 forced via xla_force_host_platform_device_count):
per-device load fixed at ``ltraj`` trajectories, total ensemble
ntraj = ltraj * ndp. For each point it verifies

* correctness: per-trajectory currents of the dp=1 run reappear
  bitwise in every wider mesh (the key schedule depends only on the
  trajectory index);
* the capacity law: the probe noise shards hold exactly ltraj
  trajectories per device at every ndp — resident noise bytes/device
  is CONSTANT while total capacity grows linearly;
* the streaming law: resident windowed bytes/device vs what the
  unwindowed full batch would materialise on one device.

Wall times are recorded but indicative only — the 8 virtual CPU
"devices" share the host's cores, so perfect weak scaling is not
expected host-side; on real ICI each dp shard owns a physical chip.

Run:  python scripts/exp_spcp_capacity.py  (self-reexecs per ndp)
      python scripts/exp_spcp_capacity.py --big
        larger-load anchor (VERDICT r4 weak #7): 256 trajectories per
        device at nmd=2^14 on ndp=4/8 — the tier where the one-device
        full noise batch (3 GB) stops being materialisable next to
        state+history on a real chip while the windowed residency
        stays at 6 MB/device, and the per-device load matches the
        "thousands of trajectories per chip" PERF.md projection within
        one order of magnitude instead of three.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

LTRAJ = 16            # trajectories per device (fixed per-device load)
NPH, NC, ML = 96, 12, 16
NMD, WINDOW, NSTEPS = 4096, 256, 1024


def child(ndp: int, ltraj: int = LTRAJ, nmd: int = NMD):
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import __graft_entry__ as g
    from sclmd_jax.parallel.ensemble import (ensemble_states, make_mesh,
                                             sharded_synthesis_run)

    sysf, _ = g._build(nph=NPH, nmd=nmd, ml=ML, with_factors=True)
    mesh = make_mesh({"dp": ndp})
    ntraj = ltraj * ndp
    st0 = ensemble_states(sysf, ntraj)
    t0 = time.time()
    fin, csum, probe = sharded_synthesis_run(
        mesh, sysf, st0, jax.random.PRNGKey(7), ntraj, NSTEPS,
        block=None, noise_window=WINDOW, return_noise_probe=True)
    jax.block_until_ready(fin.p)
    wall = time.time() - t0
    assert np.isfinite(np.asarray(csum)).all()

    # capacity law: every dp shard holds exactly ltraj trajectories
    per_shard = set()
    for arr in probe:
        per_shard |= {s.data.shape[0] for s in arr.addressable_shards}
    assert per_shard == {ltraj}, (per_shard, ltraj)

    item = np.dtype(np.asarray(fin.p).dtype).itemsize
    ncs = [b.nc for b in sysf.baths]
    resident = sum(ltraj * (WINDOW + 1) * nc * item for nc in ncs)
    full_one_dev = sum(ntraj * nmd * nc * item for nc in ncs)
    print("CHILD_JSON:" + json.dumps({
        "ndp": ndp, "ntraj": ntraj,
        "per_shard_traj": ltraj,
        "resident_noise_mb_per_device": round(resident / 2 ** 20, 3),
        "full_batch_noise_mb_one_device": round(full_one_dev / 2 ** 20,
                                                3),
        "wall_s": round(wall, 2),
        "csum": np.asarray(csum).tolist(),
    }))


def main(big: bool = False):
    # --big: the load-bearing anchor point for the PERF.md ICI
    # projection — 256 trajectories/device at nmd=2^14 (the flagship
    # noise length), where the one-device full batch is ~3 GB
    points = [(4, 256, 16384), (8, 256, 16384)] if big else \
        [(ndp, LTRAJ, NMD) for ndp in (1, 2, 4, 8)]
    rows = []
    base = None
    for ndp, ltraj, nmd in points:
        env = dict(os.environ)
        flags = re.sub(r"--xla_force_host_platform_device_count=\d+",
                       "", env.get("XLA_FLAGS", ""))
        env["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={ndp}"
        ).strip()
        env.pop("JAX_PLATFORMS", None)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             str(ndp), str(ltraj), str(nmd)],
            capture_output=True, text=True, timeout=3600, env=env,
            cwd=REPO)
        out = None
        for line in r.stdout.splitlines():
            if line.startswith("CHILD_JSON:"):
                out = json.loads(line[len("CHILD_JSON:"):])
        if out is None:
            raise RuntimeError(f"ndp={ndp} failed:\n{r.stderr[-3000:]}")
        csum = np.asarray(out.pop("csum"))
        if base is None:
            base = csum
        else:
            # trajectory-keyed noise: the first trajectories of a
            # wider mesh ARE the narrower ensemble, bitwise
            np.testing.assert_array_equal(csum[:len(base)], base)
        rows.append(out)

    ltraj, nmd = points[0][1], points[0][2]
    print(f"\nSP/CP weak scaling (virtual CPU mesh; "
          f"ltraj={ltraj}/device, nmd={nmd}, window={WINDOW}):")
    print(f"{'ndp':>4} {'ntraj':>6} {'resident MB/dev':>16} "
          f"{'full-batch MB (1 dev)':>22} {'wall s':>8}")
    for o in rows:
        print(f"{o['ndp']:>4} {o['ntraj']:>6} "
              f"{o['resident_noise_mb_per_device']:>16} "
              f"{o['full_batch_noise_mb_one_device']:>22} "
              f"{o['wall_s']:>8}")
    res = {o["resident_noise_mb_per_device"] for o in rows}
    assert len(res) == 1, f"per-device residency not constant: {res}"
    print("\ncapacity law holds: constant resident bytes/device, "
          "total trajectories ∝ ndp, narrower-mesh currents reproduced "
          "bitwise inside every wider mesh")


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(int(sys.argv[2]), *map(int, sys.argv[3:5]))
    else:
        main(big="--big" in sys.argv)
