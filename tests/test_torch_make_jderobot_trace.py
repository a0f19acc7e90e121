"""The trace command (``io/make_jderobot_trace.py``, the counterpart of
``scripts/make_jderobot_trace.py``): ``--check`` records both committed
traces of ``data/jderobot/`` again byte for byte, a changed byte fails it,
and the command's default output never lands in ``data/``."""

import hashlib
import json
import os
import shutil

import pytest
import torch

from fastslam_tpu_torch.io import make_jderobot_trace

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data", "jderobot")


def flags(kw):
    names = {"seed": "--seed", "x": "--x", "y": "--y", "yaw": "--yaw",
             "range_noise": "--range-noise"}
    return [a for k, v in kw.items() for a in (names[k], str(v))]


@pytest.mark.parametrize("name", sorted(make_jderobot_trace.COMMITTED))
def test_check_reproduces_the_committed_trace(name, capsys):
    path = os.path.join(DATA, name)
    argv = flags(make_jderobot_trace.COMMITTED[name]) + ["--device", "cpu", "--check", path]
    assert make_jderobot_trace.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["equal"] and out["ticks"] == 300 and out["beams"] == 180
    assert out["sha256"] == hashlib.sha256(open(path, "rb").read()).hexdigest()
    assert out["device"] == "cpu" and out["against"] == f"data/jderobot/{name}"


def test_the_committed_traces_are_the_ones_in_data():
    assert sorted(make_jderobot_trace.COMMITTED) == sorted(
        f for f in os.listdir(DATA) if f.endswith(".jsonl"))


def test_a_changed_byte_fails_the_check(tmp_path, capsys):
    changed = tmp_path / "corridor.jsonl"
    shutil.copy(os.path.join(DATA, "corridor_seed3_300.jsonl"), changed)
    data = bytearray(changed.read_bytes())
    at = data.index(b'"values": [') + len(b'"values": [') + 2    # a digit of the first range
    data[at] = ord("1") if data[at] != ord("1") else ord("2")
    changed.write_bytes(bytes(data))
    assert make_jderobot_trace.main(["--device", "cpu", "--check", str(changed)]) == 1
    assert json.loads(capsys.readouterr().out)["equal"] is False


def test_the_default_output_is_not_data(tmp_path, monkeypatch, capsys):
    digests = {f: hashlib.sha256(open(os.path.join(DATA, f), "rb").read()).hexdigest()
               for f in os.listdir(DATA)}
    monkeypatch.chdir(tmp_path)
    assert make_jderobot_trace.main(["--device", "cpu", "--ticks", "5"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["out"] == make_jderobot_trace.OUT and not os.path.isabs(out["out"])
    assert (tmp_path / "runs" / "jderobot" / "trace.jsonl").exists()
    assert digests == {f: hashlib.sha256(open(os.path.join(DATA, f), "rb").read()).hexdigest()
                       for f in os.listdir(DATA)}


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_jderobot_trace.main(["--check"])
