"""The port's benchmark (dump1090_tpu_torch/tools/bench.py, with its inputs
in tools/air.py) against the repository root's bench.py, imported
read-only, and the JAX package on the CPU.

bench.py keeps its tiling, perturbation, sparse batch and byte counts
inline in main(); the tests rebuild the tiling from the JAX package's
overlapping_buffers, the sparse batch from its utils/synth.py, and take
`perturb` and the roofline byte formula out of bench.py's own source (ast)
so that the JAX side is bench.py's code, unedited.  The sustained run's
messages and raw bytes over tiny groups (2 buffers a batch, 2 batches a
group, 2 groups cycled 3 times, the cache chained) equal chained JAX
demod_resolve_group + interleave_packed + raw_lines_from_fields; the fused
phase's outputs over the perturbed batches equal JAX demod_resolve_batch;
the tool's main runs on --device cpu.  Input: 2 blocks of the planted air
(utils/synth.py, seed 1) in a temporary file.  Tolerance: exact equality.
"""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dump1090_tpu_torch.tools import air
from dump1090_tpu_torch.tools import bench as tbench
from dump1090_tpu_torch.tools import measure as tmeasure

REPO = Path(__file__).resolve().parent.parent
NB, G, W, T = 2, 2, 2, 3
NOW = 1_700_000_000


def _bench_main() -> ast.FunctionDef:
    tree = ast.parse((REPO / "bench.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _bench_assign(name: str) -> ast.expr:
    """The expression bench.py's main() assigns to `name`."""
    return next(n.value for n in ast.walk(_bench_main())
                if isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name) and n.targets[0].id == name)


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
    """(path, bytes, planted) of 2 blocks of the planted air."""
    from dump1090_tpu_torch.utils.synth import planted_capture

    data, planted = planted_capture(2, 150, seed=1)
    path = tmp_path_factory.mktemp("air") / "air2.bin"
    path.write_bytes(data)
    return path, np.frombuffer(data, np.uint8), planted


def test_stream_is_the_file_or_the_planted_air(capture, tmp_path):
    path, raw, _ = capture
    np.testing.assert_array_equal(air.stream(path), raw)
    from dump1090_tpu_torch.utils.synth import planted_capture

    want = planted_capture(16, 150, seed=1)[0]
    assert air.stream().tobytes() == want
    with pytest.raises(FileNotFoundError):
        air.stream(tmp_path / "absent.bin")


@pytest.mark.parametrize("nb,g,w", [(2, 2, 2), (3, 1, 2)])
def test_bench_tiling_equals_jax(capture, nb, g, w):
    """bench.py:293-305 over the JAX package's overlapping_buffers."""
    from dump1090_tpu.parallel.sharding import overlapping_buffers

    _, raw, _ = capture
    n_bufs_total = w * g * nb
    reps = int(np.ceil((n_bufs_total + w * g) * 131072 * 2 / len(raw)))
    stream = np.concatenate([np.full(476, 127, np.uint8)] + [raw] * reps)
    bufs = np.asarray(overlapping_buffers(stream))
    want = [np.stack([bufs[(j * g + k) * nb: (j * g + k) * nb + nb] for k in range(g)])
            for j in range(w)]
    got = air.bench_groups(raw, nb, g, w)
    assert len(got) == len(want) == w
    for a, b in zip(got, want):
        assert a.shape == (g, nb, 262620)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["u1", "<u2"])
@pytest.mark.parametrize("i", [0, 1, 255, 2**31 - 1])
def test_perturb_equals_bench(capture, dtype, i):
    """air.perturb against bench.py's own perturb (bench.py:438-441)."""
    fn = next(n for n in ast.walk(_bench_main())
              if isinstance(n, ast.FunctionDef) and n.name == "perturb")
    ns = {"lax": lax, "jnp": jnp}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bench.py", "exec"), ns)
    _, raw, _ = capture
    x = air.load_buffers(raw, 2).view(dtype)
    want = np.asarray(ns["perturb"](jnp.asarray(x), jnp.int32(i)))
    got = air.perturb(torch.from_numpy(x), i).numpy()
    np.testing.assert_array_equal(got, want)


def test_sparse_batch_equals_jax():
    """bench.py:594-609 over the JAX package's utils/synth.py."""
    from dump1090_tpu.utils.synth import frame_to_iq, make_df17_frame

    nb, nbytes = 3, 262620
    rng = np.random.default_rng(5)
    want = np.full((nb, nbytes), 127, dtype=np.uint8)
    for b in range(nb):
        at = 600
        for k in range(3):
            iq = frame_to_iq(make_df17_frame(0x100000 + 64 * b + k), amplitude=80,
                             noise_sigma=2.0, phase=float(rng.uniform(0, 6.28)), rng=rng)
            want[b, at: at + len(iq)] = iq
            at += len(iq) + 70000
    np.testing.assert_array_equal(air.sparse_batch(nb, nbytes), want)


@pytest.mark.parametrize("nb,s,mc,mos,mol", [(128, 131310, 256, 5632, 9216),
                                             (4, 1000, 64, 2048, 2048)])
def test_stage_bytes_equals_bench_formula(nb, s, mc, mos, mol):
    """The roofline byte count against bench.py's `by` and
    `resolve_bytes` (bench.py:567-580), evaluated from its source."""
    ns = {"NB": nb, "S_samp": s, "MC": mc, "MOS": mos, "MOL": mol}
    by = eval(compile(ast.Expression(_bench_assign("by")), "bench.py", "eval"), ns)
    resolve = eval(compile(ast.Expression(_bench_assign("resolve_bytes")), "bench.py", "eval"),
                   ns)
    got = tbench.stage_bytes(nb, s, mc, mos, mol)
    assert got["by"] == by
    assert got["demod"] == sum(by.values()) and got["resolve"] == resolve


def _jax_group(x16, ca, ct):
    from dump1090_tpu.ops.resolve import demod_resolve_group

    return demod_resolve_group(
        jnp.asarray(x16), ca, ct, jnp.int32(NOW), jnp.asarray(True), jnp.asarray(False),
        scan_len=131070, max_candidates=tbench.MC, max_out_short=tbench.MOS,
        max_out_long=tbench.MOL, crcok_only=True, pallas=False, packed=True,
    )


def test_uint16_group_equals_uint8(capture):
    """The port's group entry on the uint16 I|Q<<8 pairs (the bench's
    resident form) gives the uint8 entry's outputs."""
    from dump1090_tpu_torch.ops.resolve import demod_resolve_group

    _, raw, _ = capture
    x = air.bench_groups(raw, NB, G, 1)[0]
    z = torch.zeros(1024, dtype=torch.int32)
    kw = dict(scan_len=131070, max_candidates=256, max_out_short=512, max_out_long=1024,
              packed=True)
    a = demod_resolve_group(torch.from_numpy(x), z, z, NOW, True, False, **kw)
    b = demod_resolve_group(torch.from_numpy(x.view("<u2")), z, z, NOW, True, False, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_sustained_run_equals_chained_jax_groups(capture):
    """Every group's raw bytes, the message count and the cache after the
    last group, against the JAX group program chained over the same
    groups and formatted by the JAX host path; and every planted frame of
    the first group with at most one flipped bit is among its lines."""
    from dump1090_tpu.native import raw_lines_from_fields
    from dump1090_tpu.ops.resolve import interleave_packed

    _, raw, planted = capture
    groups_np = air.bench_groups(raw, NB, G, W)
    groups = tbench.upload_groups(groups_np, torch.device("cpu"))
    assert groups[0].dtype == torch.uint16 and groups[0].shape == (G, NB, 131310)
    z = torch.zeros(1024, dtype=torch.int32)
    program = tbench.Group()
    res = tbench.sustained_run(program, groups, z, z.clone(), t=T, keep=True)

    ca = ct = jnp.zeros(1024, jnp.int32)
    want, n_msgs = [], 0
    for k in range(T):
        out = _jax_group(np.ascontiguousarray(groups_np[k % W]).view("<u2"), ca, ct)
        n, count, clong, shorts, longs, stats, ca, ct = (np.asarray(o) for o in out)
        lines = []
        for b in range(G):
            msg, bits = interleave_packed(count[b], clong[b], shorts[b], longs[b])
            n_msgs += msg.shape[0]
            lines.append(raw_lines_from_fields(msg, bits, np.ones(msg.shape[0], dtype=bool)))
        want.append(b"".join(lines))
    assert res["raw"] == want
    assert res["messages"] == n_msgs > 0 and res["raw_bytes"] == sum(map(len, want))
    np.testing.assert_array_equal(res["ca"].numpy(), np.asarray(ca))
    np.testing.assert_array_equal(res["ct"].numpy(), np.asarray(ct))
    # unformatted (measure.sustained's protocol): the same messages counted
    # and the same cache, no bytes
    bare = tbench.sustained_run(program, groups, z, z.clone(), t=T, depth=1, formatted=False)
    assert bare["messages"] == n_msgs and bare["raw_bytes"] == 0
    np.testing.assert_array_equal(bare["ca"].numpy(), np.asarray(ca))
    assert tmeasure.sustained(program, groups, T, depth=3)[1] == n_msgs
    # the first group covers the first G*NB blocks of the tiled air; each
    # frame planted there with at most one flipped bit comes out clean
    lines = set(res["raw"][0].split())
    n_blocks = len(raw) // 262144
    fixable = {b"*" + c.hex().encode() + b";" for blk, _, c, nflip in planted
               if nflip <= 1 and blk < min(G * NB, n_blocks)}
    assert fixable and fixable <= lines


def test_fused_steps_equal_jax(capture):
    """The fused phase's steps (demod_resolve_batch over the perturbed
    uint16 batch, the cache chained) against JAX demod_resolve_batch over
    bench.py's perturbation of the same batch."""
    from dump1090_tpu.ops.resolve import demod_resolve_batch

    _, raw, _ = capture
    x16 = np.ascontiguousarray(air.bench_groups(raw, NB, 1, 1)[0][0]).view("<u2")
    ca = ct = torch.zeros(1024, dtype=torch.int32)
    jca = jct = jnp.zeros(1024, jnp.int32)
    kw = dict(mc=tbench.MC, mos=tbench.MOS, mol=tbench.MOL)
    for i in range(2):
        got = tbench.fused_step(torch.from_numpy(x16), i, ca, ct, **kw)
        xi = air.perturb(torch.from_numpy(x16), i).numpy()
        want = demod_resolve_batch(
            jnp.asarray(xi), jca, jct, jnp.int32(NOW), jnp.asarray(True), jnp.asarray(False),
            scan_len=131070, max_candidates=kw["mc"], max_out_short=kw["mos"],
            max_out_long=kw["mol"], crcok_only=True, pallas=False, packed=True,
        )
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        ca, ct, jca, jct = got[6], got[7], want[6], want[7]
    acc, _, _ = tbench.fused_loop(torch.from_numpy(x16), ca, ct, 2, **kw)
    assert float(acc) > 0


def test_main_on_cpu(capture, monkeypatch, capsys, tmp_path):
    """The whole protocol on --device cpu at tiny shapes, with a long-frame
    cap the air overflows: exit 0, one JSON line saying platform cpu with
    no roofline share, the cap grown to fit; the CPU run saves no
    last-success record.  A failed run prints value 0 with its error."""
    monkeypatch.setenv("HOME", str(tmp_path))
    path, _, _ = capture
    argv = ["--device", "cpu", "--input", str(path), "--nb", "2", "--g", "2", "--w", "2",
            "--t", "2", "--cold-mb", "1", "--loops", "1", "--mol", "100"]
    assert tbench.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the long-frame cap grew x4 on the first group until it fit
    assert rec["shapes"]["mol"] == 400 and 100 < rec["emission_peaks"]["longs"] <= 400
    assert rec["metric"] == "sustained_e2e" and rec["unit"] == "Msamples/s/chip"
    assert rec["device"]["platform"] == "cpu" and "sol_fraction" not in rec
    assert rec["value"] > 0 and rec["messages"] > 0 and rec["sparse"]["mc"] == 64
    assert rec["cold_file"]["messages"] > 0 and rec["cold_file"]["file_bytes"] >= 1_000_000
    assert not (tmp_path / ".cache").exists()
    assert tbench.main(["--device", "cpu", "--input", str(tmp_path / "absent.bin")]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] == 0 and "FileNotFoundError" in rec["error"]
    assert "last_successful" not in rec


@pytest.mark.parametrize("skip,cold_mb", [(None, 7), ("", 7), ("1", 0)])
def test_skip_cold_environment_is_cold_mb_0(monkeypatch, capsys, skip, cold_mb):
    """$DUMP1090_BENCH_SKIP_COLD, read as bench.py reads it (any non-empty
    value), skips the cold file as --cold-mb 0 does."""
    if skip is None:
        monkeypatch.delenv("DUMP1090_BENCH_SKIP_COLD", raising=False)
    else:
        monkeypatch.setenv("DUMP1090_BENCH_SKIP_COLD", skip)
    seen = []
    monkeypatch.setattr(tbench, "run", lambda args, dev: seen.append(args.cold_mb) or {})
    assert tbench.main(["--device", "cpu", "--cold-mb", "7"]) == 0
    assert seen == [cold_mb] and capsys.readouterr().out.strip() == "{}"
