"""The port's routers, rehearsed on the CPU with the card's rules.

`tapnet_torch.train.rollout.routes` picks, per config and hidden width, the
kernel each router takes on the card: K2 (`actor_select_step`) for sampled
decode, else K1 (`select_step`), else the general decode loop; the replay
kernels (K5), else the windowed or general replay; K4
(`fused_rollout_batch`) for `pack(first/random)` and
`evaluate(baselines=True)`, else `env.core.rollout_batch`. Each kernel only
where its own `eligible` covers the config, as the JAX package's routers
ask. On the CPU the routers take no kernel; here `routes` is patched to
answer as on the card, so the routers send CPU tensors down the card's
paths (the kernel wrappers run their plain versions) and the results are
held to the reference path's: bit-equal plans, equal train-step metrics.
"""

import numpy as np
import pytest

import tapnet_torch as T
from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.models.tapnet import init_params
from tapnet_torch.ops import actor_step as AS
from tapnet_torch.ops import env as OE
from tapnet_torch.ops import policy_step as PS
from tapnet_torch.ops import replay as RP
from tapnet_torch.train import rollout as RO

# five containers: past K2 and K5 (C <= 4), inside K1 and K4
FIVE = TAPConfig(num_containers=5, container_height=30)
# a 17 x 16 target: past K1, K2 and K4 (W*D <= 256), inside K5
WIDE = TAPConfig(dim=3, container_width=17, container_depth=16,
                 container_height=8, target_width=17, target_depth=16,
                 allow_rot=True)


@pytest.fixture
def card_rules(monkeypatch):
    """`routes` answering as on the card, and the paths the routers took."""
    routes = RO.routes
    monkeypatch.setattr(RO, "routes",
                        lambda cfg, on_card, *a, **k: routes(cfg, True, *a,
                                                             **k))
    taken = []
    for name in ("_rollout_record_actorfused", "_rollout_record_stepfused",
                 "_rollout_record_general", "_replay_logp_kernel",
                 "_replay_logp_windowed", "_replay_logp_general"):
        fn = getattr(RO, name)
        monkeypatch.setattr(RO, name, lambda *a, _fn=fn, _n=name, **k: (
            taken.append(_n), _fn(*a, **k))[1])
    for mod, name in ((AS, "actor_select_step_live_ref"),
                      (OE, "fused_rollout_batch_ref")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            taken.append(_n), _fn(*a, **k))[1])
    return taken


@pytest.mark.parametrize("hidden", [32, 48, 128, 256])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_routes_follow_eligible(name, hidden):
    """Each kernel exactly where the port's `eligible` says; none on the
    CPU; greedy decode never on K2."""
    cfg = CONFIGS[name]
    for greedy in (False, True):
        r = RO.routes(cfg, True, hidden, greedy=greedy)
        want = ("actor" if not greedy and AS.eligible(cfg, hidden)
                else "step" if PS.eligible(cfg) else "general")
        assert r == RO.Routes(want, RP.eligible(cfg, hidden),
                              OE.eligible(cfg))
        assert RO.routes(cfg, False, hidden, greedy) == RO.Routes(
            "general", False, False)
    # the six configs: K1 and K4 cover all; K2 all but the capped one at
    # hidden widths that are multiples of 32 up to 128, K5 all at those
    tiled = hidden in (32, 128)
    assert PS.eligible(cfg) and OE.eligible(cfg)
    assert AS.eligible(cfg, hidden) == (tiled and cfg.target_height == 0)
    assert RP.eligible(cfg, hidden) == tiled


def test_uncovered_configs():
    assert not AS.eligible(FIVE, 32) and not RP.eligible(FIVE, 32)
    assert PS.eligible(FIVE) and OE.eligible(FIVE)
    assert not AS.eligible(WIDE, 32) and not PS.eligible(WIDE)
    assert not OE.eligible(WIDE) and RP.eligible(WIDE, 32)  # K5: any W*D
    assert RO.routes(FIVE, True, 32) == RO.Routes("step", False, True)
    assert RO.routes(WIDE, True, 32) == RO.Routes("general", True, False)


def _metrics(cfg, hidden, batch=8):
    ts = T.init_train_state(0, cfg, hidden=hidden, device="cpu")
    _, m = T.make_train_step(cfg, batch=batch, hidden=hidden,
                             device="cpu")(ts)
    return {k: float(v) for k, v in m.items()}


def test_train_step_past_the_kernels_falls_back(card_rules):
    """Hidden 48 is past K2 and the replay kernels: the card's route is the
    step-fused rollout (K1's plain version) and the general replay, with
    the reference path's metrics."""
    cfg = CONFIGS["2d-basic"]
    got = _metrics(cfg, 48)
    assert card_rules == ["_rollout_record_stepfused",
                          "_replay_logp_general"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RO, "routes", lambda cfg, on_card, *a, **k: RO.Routes(
            "general", False, False))
        want = _metrics(cfg, 48)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_train_step_inside_the_kernels_takes_them(card_rules):
    """Hidden 32 on 2d-basic: the actor-fused rollout in its live-column
    mode (K2's plain live version) and the replay kernel path, with the
    reference path's losses."""
    cfg = CONFIGS["2d-basic"]
    got = _metrics(cfg, 32)
    assert card_rules.count("actor_select_step_live_ref") == cfg.num_blocks
    assert "_rollout_record_actorfused" in card_rules
    assert "_replay_logp_kernel" in card_rules
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RO, "routes", lambda cfg, on_card, *a, **k: RO.Routes(
            "general", False, False))
        want = _metrics(cfg, 32)
    for k in ("loss_actor", "loss_critic", "reward", "C", "P", "S"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _plans_equal(a, b):
    for f in a.states._fields:
        np.testing.assert_array_equal(getattr(a.states, f),
                                      getattr(b.states, f), err_msg=f)
    np.testing.assert_array_equal(a.actions, b.actions)
    np.testing.assert_array_equal(a.rewards, b.rewards)


@pytest.mark.parametrize("cfg, decode, k4", [
    (FIVE, "_rollout_record_stepfused", "fused_rollout_batch_ref"),
    (WIDE, "_rollout_record_general", None)], ids=["five", "wide"])
def test_pack_past_the_kernels_falls_back(card_rules, cfg, decode, k4):
    """pack() on configs past K2 (and K1, K4 for the wide one): the card's
    route takes the step-fused or the general decode and K4's plain version
    or the env's own rollout, with the reference path's plans."""
    inst = sample_batch(R.key(3), 12, cfg)
    actor = init_params(0, cfg, 32, "cpu")
    got = {p: T.pack(inst, cfg, actor, policy=p, key=5, device="cpu")
           for p in ("sample", "first", "random")}
    assert card_rules.count(decode) == 1
    assert card_rules.count("fused_rollout_batch_ref") == (2 if k4 else 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RO, "routes", lambda cfg, on_card, *a, **k: RO.Routes(
            "general", False, False))
        for p, plan in got.items():
            _plans_equal(plan, T.pack(inst, cfg, actor, policy=p, key=5,
                                      device="cpu"))
