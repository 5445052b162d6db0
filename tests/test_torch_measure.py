"""The port's measurement tools on the CPU: the instrumented copies of the
CUDA sources that `profile_phases` builds (every phase mark found exactly
once in the package's sources, so a change to a kernel cannot silently
drop a phase), and `kernel_times`' bit-identity check of the float32 K5
kernels against another run's line."""

import json

import pytest
import torch

from tapnet_torch import kernel_times as KT
from tapnet_torch import profile_phases as PP
from tapnet_torch.ops import _build


@pytest.mark.parametrize("source,instrument", [
    ("actor_step.cu", PP.instrumented_source),
    ("env.cu", PP.rollout_source),
    ("replay.cu", PP.replay_source)])
def test_phase_marks_found_once(source, instrument):
    src = (_build.CSRC / source).read_text()
    out = instrument(src)
    assert "tapnet_prof_read" in out and "prof_ts" in out
    assert out.count("clock64()") > src.count("clock64()")


def test_replay_marks_cover_every_phase():
    """Every slot of REPLAY_PHASES but the epilogue's is ended by a mark,
    and the replay copy stores the slots at both exits of the kernel."""
    slots = {k for _, k, _ in PP.REPLAY_MARKS}
    assert slots == set(range(PP.KSLOTS)) - {8}
    assert len(PP.REPLAY_PHASES) == PP.KSLOTS
    out = PP.replay_source((_build.CSRC / "replay.cu").read_text())
    assert out.count(f"prof_acc[{8}] +=") == 2


def test_sha_covers_bytes_and_dtypes():
    a = torch.arange(6, dtype=torch.float32)
    assert KT._sha([a]) == KT._sha([a.clone()])
    assert KT._sha([a]) != KT._sha([a.to(torch.bfloat16)])
    b = a.clone()
    b[3] = torch.nextafter(b[3], torch.tensor(10.0))
    assert KT._sha([a]) != KT._sha([b])
    assert len(KT._sha([a.view(2, 3).T])) == 16


def test_check_expected(tmp_path):
    """Every recorded hash decides (K2 float32, K5 in both dtypes); a
    differing one fails, in either dtype."""
    line = {"tag": "parent", "K5b f32 2d-basic": 2.5,
            "K5b f32 2d-basic sha": {"operands": "a", "outputs": "b"},
            "K5b bf16 2d-basic sha": {"operands": "c", "outputs": "d"},
            "K2 main f32 2d-basic sha": {"operands": "e", "outputs": "f"}}
    path = tmp_path / "kt.json"
    path.write_text("noise\n" + json.dumps(line) + "\n")
    same = {k: dict(v) for k, v in line.items() if k.endswith(" sha")}
    assert KT.check_expected(same, str(path))
    for k in same:
        moved = {**same, k: {**same[k], "outputs": "x"}}
        assert not KT.check_expected(moved, str(path)), k
