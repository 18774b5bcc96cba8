"""The port's probes (dump1090_tpu_torch/tools/measure.py) and front A/B
(tools/exp_demod_front.py) against the JAX tools of the same names,
imported read-only, on the CPU.

The JAX tools read their capture through a module FIXTURE; the tests point
it at a temporary file of 2 blocks of the planted air (utils/synth.py,
seed 1) with monkeypatch and compare the tilings byte for byte.  Every
group-front arrangement of ab-front2 equals the JAX tool's arrangement of
the same name on the same group, and every exp_demod_front variant the JAX
front of the same name on the same magnitudes (air and noise rows).  Each
probe and the A/B run through main on --device cpu at tiny shapes (2
buffers a batch, 2 batches a group, 2 groups a run, 1 loop): exit 0, one
JSON line saying platform cpu, no share.  Tolerance: exact equality.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dump1090_tpu_torch.tools import air
from dump1090_tpu_torch.tools import exp_demod_front as texp
from dump1090_tpu_torch.tools import measure as tmeasure

REPO = Path(__file__).resolve().parent.parent


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers run side by side, and
    oversubscribed threads slow the many small CPU ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, _ = planted_capture(2, 150, seed=1)
    path = tmp_path_factory.mktemp("air") / "air2.bin"
    path.write_bytes(data)
    return path, np.frombuffer(data, np.uint8)


@pytest.fixture(scope="module")
def jmeasure():
    return _load("jax_tools_measure", REPO / "tools" / "measure.py")


@pytest.fixture(scope="module")
def jexp():
    return _load("jax_tools_exp_demod_front", REPO / "tools" / "exp_demod_front.py")


@pytest.mark.parametrize("n", [1, 3, 5])
def test_load_buffers_equals_jax(capture, jmeasure, monkeypatch, n):
    path, raw = capture
    monkeypatch.setattr(jmeasure, "FIXTURE", path)
    want = jmeasure.load_buffers(n)
    got = air.load_buffers(raw, n)
    assert got.shape == want.shape == (n, 262620)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nb", [2, 20])
def test_load_batch_and_noise_equal_jax(capture, jexp, monkeypatch, nb):
    """exp_demod_front's batch (8 reps of the capture) and its noise rows
    (seed 7, as its main draws them)."""
    path, raw = capture
    monkeypatch.setattr(jexp, "FIXTURE", path)
    want = jexp.load_batch(nb)
    got = air.load_batch(raw, nb)
    np.testing.assert_array_equal(got, want)
    noise = np.random.default_rng(7).integers(0, 256, want[:8].shape, np.uint8)
    np.testing.assert_array_equal(air.noise_rows(got), noise)


@pytest.fixture(scope="module")
def group(capture):
    """One group of 2 batches of 2 buffers, uint8 (G, NB, 262620)."""
    return air.load_buffers(capture[1], 4).reshape(2, 2, -1)


@pytest.mark.parametrize("name", ["scan", "hoist", "pin", "flat", "hoist16"])
def test_front_variant_equals_jax(group, jmeasure, name):
    """ab-front2's arrangement `name`: (m, n, pos) of the group equal the
    JAX tool's arrangement of the same name (int32 against uint16 m)."""
    x = group.view("<u2") if name.endswith("16") else group
    m, n, pos = tmeasure.front_variants()[name](torch.from_numpy(x), scan_len=131070,
                                                max_candidates=256)
    jm, jn, jpos = (np.asarray(a) for a in jmeasure._front_variants()[name](
        jnp.asarray(x), scan_len=131070, max_candidates=256))
    g, nb = group.shape[:2]
    np.testing.assert_array_equal(m.numpy(), jm.reshape(g * nb, -1).astype(np.int32))
    np.testing.assert_array_equal(n.numpy(), jn.reshape(-1))
    np.testing.assert_array_equal(pos.numpy(), jpos.reshape(g * nb, -1))


@pytest.mark.parametrize("name", sorted(texp.VARIANTS))
def test_exp_front_variant_equals_jax(group, jexp, name):
    """exp_demod_front's variant `name` against the JAX tool's, on the
    air's magnitudes and on its noise rows."""
    from dump1090_tpu.ops.magnitude import magnitude_from_iq as jmag
    from dump1090_tpu_torch.ops.magnitude import magnitude_from_iq

    import jax

    iq = group.reshape(4, -1)
    for rows in (iq, air.noise_rows(iq)):
        m = magnitude_from_iq(torch.from_numpy(rows))
        jm = jax.vmap(lambda r: jmag(r, out_dtype=jnp.uint16))(jnp.asarray(rows))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm).astype(np.int32))
        n, pos = texp.run_variant(name, m, 256)
        jn, jpos = jexp.VARIANTS[name](jm, 131070, 256)
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def _is_share(key: str) -> bool:
    return key == "sol" or key.startswith("sol_") or key.endswith("share")


def _no_share(obj) -> bool:
    if isinstance(obj, dict):
        return all(not _is_share(k) and _no_share(v) for k, v in obj.items())
    if isinstance(obj, list):
        return all(_no_share(v) for v in obj)
    return True


def test_every_probe_and_flag_of_the_jax_tool_is_accepted(jmeasure):
    assert set(tmeasure.PROBES) == set(jmeasure.PROBES)
    flags = {a.option_strings[0] for a in _parser_of(jmeasure)._actions if a.option_strings}
    flags -= {"-h", "--allow-cpu"}  # --allow-cpu is --device cpu
    ours = {a.option_strings[0] for a in _parser_of(tmeasure)._actions if a.option_strings}
    assert flags <= ours and "--device" in ours


def _parser_of(mod):
    """The ArgumentParser a tool's main builds, caught before it parses."""
    import argparse

    class Caught(Exception):
        pass

    seen = {}

    def parse(self, *a, **k):
        seen["p"] = self
        raise Caught

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        mod.main()
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["p"]


@pytest.mark.parametrize("probe", sorted(tmeasure.PROBES))
def test_probe_main_on_cpu(capture, capsys, tmp_path, probe):
    path, _ = capture
    rc = tmeasure.main(["--probe", probe, "--device", "cpu", "--input", str(path), "--nb", "2",
                        "--g", "2", "--t", "2", "--loops", "1", "--trace-dir", str(tmp_path)])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["probe"] == probe and rec["device"]["platform"] == "cpu"
    assert _no_share(rec), rec


def test_exp_demod_front_main_on_cpu(capture, capsys):
    path, _ = capture
    assert texp.main(["--check", "--time", "--device", "cpu", "--input", str(path), "--nb", "2",
                      "--loops", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert sum("bit-identical to v0" in ln for ln in out) == 4
    rec = json.loads(out[-1])
    assert rec["device"]["platform"] == "cpu" and rec["check"] == "bit-identical"
    assert set(rec["ms_per_batch"]) == set(texp.VARIANTS) and _no_share(rec)
