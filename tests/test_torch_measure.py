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


def test_k2_pass_mark_found_once():
    """K2's named marks (`K2_MARK(k)`, nothing in the normal build): the
    package's source ends every phase of K2_PHASES but the last (stored at
    the kernel's end) with a mark, and the copy defines the marks as clock
    reads into slot k."""
    import re
    src = (_build.CSRC / "actor_step.cu").read_text()
    slots = {int(m) for m in re.findall(r"K2_MARK\((\d+)\);", src)}
    assert slots == set(range(len(PP.K2_PHASES) - 1))
    assert "#ifndef K2_MARK\n#define K2_MARK(k)\n#endif" in src
    out = PP.instrumented_source(src)
    assert out.startswith("#define K2_MARK(k) ")
    assert "prof_acc[k] +=" in out
    assert out.count(f"prof_acc[{len(PP.K2_PHASES) - 1}] +=") == 1
    assert PP.SLOTS == len(PP.K2_PHASES)


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


def test_grad_witness_plain_against_plain():
    """On CPU tensors both sides of `grad_witness` are the plain step-grid
    replay: every scaled error 0 and no gate to look at."""
    from tapnet_torch import CONFIGS
    from tapnet_torch import grad_witness as GW

    res = GW.witness(CONFIGS["2d-rolling"], 32, 4, 10, torch.device("cpu"))
    assert res["schedule"] == "steps" and res["gates"] == []
    assert len(res["scaled_errors"]) == 13
    assert max(res["scaled_errors"].values()) == 0.0


def test_nearest_gate_finds_a_pre_activation_at_zero():
    """W1's row j set so that one acting pair's pre-activation is 0 up to
    rounding (b1 stays 0, so the empty heightmaps of step 0 give exact
    zeros too): for a W1 difference equal to minus that pair's feats,
    `nearest_gate` names a pair with those feats, cosine -1, its float64
    value within the rounding bound."""
    import chip_smoke as CS
    from tapnet_torch import CONFIGS
    from tapnet_torch import grad_witness as GW
    from tapnet_torch.models.tapnet import init_params

    cfg, dev, j = CONFIGS["2d-basic"], torch.device("cpu"), 5
    actor = init_params(0, cfg, 32, dev)
    ops, _ = CS.replay_operands(actor, cfg, 8, dev, 10, 1.0)
    acts = ops[3]
    k, b = 3, int(torch.nonzero(acts[3] >= 0)[0])
    feats = [f for kk, _, f, *_ in GW.pre_activations(ops, cfg)
             if kk == k][0][:, b]
    params = list(ops[8])
    assert not bool(params[4].any())
    w1 = params[3].clone()
    m = int(feats.abs().argmax())
    rest = w1[j].double() @ feats.double() - w1[j, m].double() * feats[m]
    w1[j, m] = float(-rest / feats[m])
    params[3] = w1
    pres = GW.pre_activations(ops[:8] + (tuple(params),), cfg)
    got = GW.nearest_gate(-feats, j, acts, pres)
    found = [f for kk, cc, f, *_ in pres
             if (kk, cc) == (got["step"], got["container"])][0]
    assert torch.equal(found[:, got["instance"]], feats)
    assert 0 < abs(got["pre_f64"]) <= got["rounding_bound"]
    assert got["cosine"] == pytest.approx(-1.0, abs=1e-12)


def test_profile_pack_fallback_route():
    """`profile_pack.routed`: under `fallback` a call sees the routers
    answer K1 decode and no replay kernel where they would take K2 and K5
    (hidden 256 on the card), and the routers are restored after it."""
    from tapnet_torch import CONFIGS
    from tapnet_torch import profile_pack as PK
    from tapnet_torch.train import rollout as RO

    cfg, seen = CONFIGS["2d-basic"], []
    step = lambda ts: seen.append(RO.routes(cfg, True, 256))
    PK.routed(step, None, "kernels")()
    PK.routed(step, None, "fallback")()
    assert seen[0] == RO.Routes("actor", True, True)
    assert (seen[1].decode, seen[1].replay) == ("step", False)
    assert RO.routes(cfg, True, 256) == seen[0]
    with pytest.raises(ValueError):
        PK.routed(step, None, "general")
