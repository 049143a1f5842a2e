"""chip_smoke.py's phases at TINY sizes, and its refusal to run without
a GPU. The FULL sizes run on the card: ``python chip_smoke.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as CS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, fn, card="cpu"):
    chk = CS.Checks(card, name)
    fn(CS.TINY[name], chk)
    assert not chk.failed, chk.failed


@pytest.mark.parametrize("name,fn", CS.ONE_CARD,
                         ids=[n for n, _ in CS.ONE_CARD])
def test_one_card_phase_tiny(name, fn):
    _run(name, fn)


def test_four_cards_phase_on_virtual_mesh():
    """Phase 5 on four of the eight virtual CPU devices."""
    _run("four_cards", CS.phase_four_cards)


@pytest.mark.gpu
def test_one_card_phases_tiny_on_gpu(gpu):
    for name, fn in CS.ONE_CARD:
        _run(name, fn, card=CS.gpu_info())


@pytest.mark.parametrize("argv", [[], ["--four-cards"]],
                         ids=["one-card", "four-cards"])
def test_main_refuses_cpu(argv, capsys):
    assert CS.main(argv) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "nothing was run" in out.err


def test_script_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_noise_variance_matches_host_samples():
    """_noise_variance (the PSD integral phase 3 compares with) against
    the host numpy sampler's empirical variance, for both factor
    layouts (shared matrix and per-frequency batch)."""
    from sclmd_jax import baths as B
    from sclmd_jax.ops.noise import sample_noise_np

    nc, nmd, dt = 9, 64, 0.4
    rng = np.random.default_rng(3)
    m = rng.normal(size=(nc, nc)) * 1e-4
    for exim in (None, m - m.T):        # proportional, then not
        b = B.ebath(range(nc), 300.0, dt, nmd, wmax=1.0, nw=50,
                    efric=np.eye(nc) * 0.01, exim=exim, bias=0.1)
        want = CS._noise_variance(b)
        x = np.stack([sample_noise_np(rng, b.nevecs, b.nstd, dt, nmd)
                      for _ in range(400)])
        v = (x ** 2).mean(axis=1)
        se = v.std(0, ddof=1) / np.sqrt(len(v))
        assert (np.abs(v.mean(0) - want) / se).max() < 5.0


def test_result_line_format(monkeypatch, capsys):
    """With a GPU present and every phase passing, the last stdout line
    is exactly the result object."""
    import jax

    class _Gpu:
        platform, device_kind = "gpu", "Fake GPU"

    monkeypatch.setattr(jax, "devices", lambda *a: [_Gpu()])
    monkeypatch.setattr(CS, "ONE_CARD", ())
    monkeypatch.setattr(CS, "gpu_info", lambda: "Fake GPU, 700.00 W")
    monkeypatch.setattr(jax.monitoring, "register_event_listener",
                        lambda cb: None)
    monkeypatch.setattr("sclmd_jax.utils.compile_cache."
                        "enable_compile_cache", lambda d: d)
    assert CS.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "Fake GPU", "count": 1}}
