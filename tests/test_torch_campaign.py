"""The port's differential campaign (dump1090_tpu_torch/tools/campaign.py)
against tools/campaign.sh, read from the file: the same stages in the same
order, with the same seeds, counts, modes and environment, each the port's
tool run as a module (the IQ tools on --device).  The runner stops at the
first failing stage with its exit code and prints CAMPAIGN PASSED only when
every stage passed; with no --ref the reference is built as campaign.sh
builds it."""

import re
import shlex
import sys
from pathlib import Path

import pytest

from dump1090_tpu_torch.tools import campaign

REPO = Path(__file__).resolve().parent.parent
IQ_TOOLS = {"fuzz_diff", "snr_sweep"}  # the tools that decode on --device


def _sh_stages(ref: str) -> list:
    """(tool, args, env) of each `python tools/<tool>.py` line of
    campaign.sh, its continuation lines joined and $REF substituted."""
    text = (REPO / "tools" / "campaign.sh").read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        words = shlex.split(line.replace('"$REF"', shlex.quote(ref)))
        env = {}
        while words and re.fullmatch(r"[A-Z_][A-Z0-9_]*=.*", words[0]):
            k, v = words.pop(0).split("=", 1)
            env[k] = v
        if words[:1] == ["python"] and words[1].startswith("tools/") and "refbuild" not in words[1]:
            out.append((Path(words[1]).stem, words[2:], env))
    return out


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_stages_equal_campaign_sh(device):
    ref = "ref dir/dump1090"  # a path with a space: passed as one word
    want = _sh_stages(ref)
    assert len(want) == 14 and want[6][2] == {"DUMP1090_TPU_FRONT": "packed"}
    got = []
    for argv, env in campaign.stages(ref, device):
        assert argv[:2] == [sys.executable, "-m"]
        tool = argv[2].removeprefix("dump1090_tpu_torch.tools.")
        args = argv[3:]
        if tool in IQ_TOOLS:
            assert args[-2:] == ["--device", device]
            args = args[:-2]
        got.append((tool, args, env))
    assert got == want


def _stage(code: str, env=None):
    return [sys.executable, "-c", code], env or {}


def test_first_failing_stage_stops_the_campaign(capsys):
    """The second of three stages exits 3: the campaign returns 3 and the
    third never runs; a stage sees its extra environment."""
    stages = [_stage("import os, sys; sys.exit(0 if os.environ['CAMPAIGN_T'] == 'y' else 5)",
                     {"CAMPAIGN_T": "y"}),
              _stage("import sys; sys.exit(3)"),
              _stage("print('third stage ran')")]
    assert campaign.run(stages) == 3
    out = capsys.readouterr().out
    assert "CAMPAIGN FAILED" in out and "CAMPAIGN PASSED" not in out
    assert "third stage ran" not in out
    assert campaign.run(stages[:1] + stages[2:]) == 0
    assert capsys.readouterr().out.rstrip().endswith("CAMPAIGN PASSED")


def test_main_builds_the_reference_without_ref(monkeypatch):
    """No --ref: the reference binary from ensure_reference, as campaign.sh
    calls refbuild.py; --ref is passed on as it is, --device to the IQ
    tools."""
    seen = []
    monkeypatch.setattr(campaign, "ensure_reference", lambda: "refbuild/dump1090")
    monkeypatch.setattr(campaign, "run", lambda stages: seen.append(stages) or 0)
    assert campaign.main([]) == 0
    assert campaign.main(["--ref", "python -m x", "--device", "cpu"]) == 0
    assert seen[0] == campaign.stages("refbuild/dump1090", "cuda")
    assert seen[1] == campaign.stages("python -m x", "cpu")
