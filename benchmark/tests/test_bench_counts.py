"""The frozen count functions at small sizes against a recount by hand."""

import pytest

from benchmark.counts import ppo as C


def test_mlp():
    assert C.mlp(3, [4, 2], 1) == (3 * 4 + 4 * 2 + 2 * 1, 4 + 2 + 1, 6)


def test_act_ops():
    # 2 envs, obs 3, actions 2, hidden [4] for both nets
    macs = (3 * 4 + 4 * 2) + (3 * 4 + 4 * 1)
    units = (4 + 2) + (4 + 1)
    assert C.act_ops(2, 3, 2, [4], [4]) == 2 * (2 * macs + units + 8 + 20)


def test_pgs_legs_ops():
    # 1 env, 10 rows from offset 2 (4 noslip pairs), 2 legs, 3 sweeps,
    # 1 noslip sweep
    prologue = 180 * 10 + 24 * 4
    sweeps = 3 * 10 * 56
    noslip = 1 * 4 * 104
    epilogue = 42 + 2 * 51
    assert C.pgs_legs_ops(1, 10, 2, 3, 1, 2) == (prologue + sweeps + noslip
                                                 + epilogue)
    assert C.pgs_legs_ops(3, 10, 2, 3, 0, 2) == 3 * (180 * 10 + 3 * 10 * 56
                                                     + 42 + 2 * 51)


def test_pgs_ops():
    # 1 env, nefc 4, nv 2, 2 sweeps, 1 noslip sweep, offset 0: 2 pairs
    prologue = 2 * 4 * 2 + 2 * 2 * 2 + 2 * 4
    assert C.pgs_ops(1, 4, 2, 2, 1, 0) == (prologue + 2 * 4 * (4 * 2 + 8)
                                           + 1 * 2 * (7 * 2 + 20))


def test_newton_ops():
    # 1 env, nefc 2, nv 3, 1 step, 0 refinements
    step = 4 * 2 * 3 + 6 * 9 + 27 / 3 + 4 * 9 + 13 * 8 * 2
    assert C.newton_ops(1, 2, 3, 1, 0) == pytest.approx(step + 2 * 2 * 3)


def _sizes(**kw):
    s = dict(num_envs=2, nefc=4, nv=2, form="dense", iterations=2, noslip=1,
             ns_offset=0, legs=0, ls_refine=0, decimation=3, num_obs=3,
             num_actions=2, actor=[4], critic=[4], params=50, terms=5,
             draws=4, state_bytes=1000, record_bytes=40, steps=5, epochs=2,
             minibatches=2)
    s.update(kw)
    return s


def test_rollout_step():
    s = _sizes()
    solve = C.pgs_ops(2, 4, 2, 2, 1, 0)
    ops = (C.act_ops(2, 3, 2, [4], [4]) + 3 * (solve + 2 * (2 * 4 * 2 + 2))
           + 2 * (3 + 5))
    reads = 1000 + 4 * (2 * 3 + 50 + 2 * 2 + 2 * 4)
    writes = 1000 + 4 * 2 * 3 + 4 * 2 * (3 + 6 + 4) + 40
    assert C.rollout_step(s) == (ops, reads + writes)


def test_learn_iteration():
    s = _sizes()
    am, cm = 3 * 4 + 4 * 2, 3 * 4 + 4 * 1
    dx = 4 * 2 + 4 * 1
    B = 5 * 2 // 2
    grads = B * (2 * (2 * (am + cm) + dx) + 4 * 8 + 30 * 2 + 20)
    ops = 13 * 5 * 2 + 4 * (grads + 16 * 50)
    nbytes = 4 * (5 * 2 * (3 + 6 + 4) + 2 * 3 + 6 * 50)
    assert C.learn_iteration(s) == (ops, nbytes)


def test_least_s():
    assert C.least_s(67e12, 0) == 1.0
    assert C.least_s(0, 3.35e12) == 1.0
    assert C.least_s(67e12, 6.7e12) == 2.0
