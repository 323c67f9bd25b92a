"""The frozen yardstick: cost formulas and peaks against hand counts and
against the port's own copies today; traffic and inputs deterministic
per seed."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.harness import inputs, requests
from bench.harness.work import Work
from bench.roofline import costs


def test_cim_mbiw_hand_count():
    # M 4, K 3, N 2, 2 planes, one beta row: 2*4*2*3*2 int8 ops;
    # bytes x 4*2*3 + w 3*2 + gamma 8 + beta 8 + out 4*4*2
    c = costs.cim_mbiw(4, 3, 2, 2, False)
    assert c.ops == 96 and c.rate == "int8"
    assert c.bytes == 24 + 6 + 8 + 8 + 32
    assert costs.cim_mbiw(4, 3, 2, 2, True).bytes == 24 + 6 + 8 + 32 + 32


def test_bound_ms_hand_count():
    t, what = costs.bound_ms(costs.Cost(ops=1979e12, bytes=0, rate="int8"))
    assert t == pytest.approx(1e3) and what == "operations"
    t, what = costs.bound_ms(costs.Cost(ops=0, bytes=3.35e12, rate=None))
    assert t == pytest.approx(1e3) and what == "bytes"


def test_work_roofline_and_mfu_hand_count():
    w = Work()
    w.add_cim(128, 64, 32, 4, False, calls=3)        # one plane at 4b
    w.add_ops("bf16", 989e9)
    ops = 2 * 128 * 64 * 32 * 3
    assert w.ops["int8"] == ops
    assert w.peak_s() == pytest.approx(ops / 1979e12 + 1e-3)
    one = max(2 * 128 * 64 * 32 / 1979e12,
              (128 * 64 + 64 * 32 + 4 * 32 + 4 * 32 + 4 * 128 * 32)
              / 3.35e12)
    assert w.cim_bound_s() == pytest.approx(3 * one)


@pytest.mark.parametrize("shape", [(1, 9, 16, 1, False), (4096, 2048, 8192,
                                                          2, True),
                                   (16, 8192, 2048, 2, True)])
def test_frozen_costs_equal_the_ports(shape):
    from repro_torch.kernels import costs as port
    assert costs.cim_mbiw(*shape) == costs.Cost(**vars(port.cim_mbiw(
        *shape)))
    assert costs.bound_ms(costs.cim_mbiw(*shape)) == port.bound_ms(
        port.cim_mbiw(*shape))


def test_frozen_peaks_and_planes_equal_the_ports():
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels.cim_mbiw.kernel import plane_layout
    assert costs.rates() == {"int8": H100_SXM.int8_ops,
                             "bf16": H100_SXM.bf16_flops,
                             "f32": H100_SXM.f32_flops}
    assert costs.H100_SXM.hbm_bw == H100_SXM.hbm_bw
    for r in range(1, 9):
        assert costs.plane_count(r) == plane_layout(r)[1]


def test_frozen_pseudo_mnist_equals_the_ports():
    from bench.harness import pseudo_mnist
    from repro_torch.data import pseudo_mnist as port
    a = pseudo_mnist.make_dataset(20, 10, seed=3)
    b = port.make_dataset(20, 10, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_images_deterministic_per_seed():
    seed = 2 ** 31 + 11
    a = inputs.images(6, seed, "cpu")
    assert torch.equal(a, inputs.images(6, seed, "cpu"))
    assert not torch.equal(a, inputs.images(6, seed + 1, "cpu"))
    assert a.shape == (6, 28, 28, 1) and a.dtype == torch.float32


def test_weights_deterministic_per_seed():
    cfg = {"r_in": 4, "r_w": 2, "max_gamma": 32.0,
           "layers": [["a", 9, 16], ["b", 144, 32]]}
    w1 = inputs.lenet_weights(cfg, 5, "cpu")
    w2 = inputs.lenet_weights(cfg, 5, "cpu")
    w3 = inputs.lenet_weights(cfg, 6, "cpu")
    assert torch.equal(w1["b"]["w"], w2["b"]["w"])
    assert not torch.equal(w1["b"]["w"], w3["b"]["w"])


def test_analytic_gamma_equals_the_ports():
    from repro_torch.core.cim_layers import (CIMConfig,
                                             analytic_log_gamma_init)
    for k, r_in, r_w, mg in ((9, 4, 2, 32.0), (1568, 4, 2, 32.0),
                             (2048, 8, 4, 2.0 ** 16), (8192, 8, 4, 2.0 ** 16)):
        cfg = CIMConfig(r_in=r_in, r_w=r_w, max_gamma=mg)
        assert inputs.analytic_log_gamma(k, r_in, r_w, 8, mg) == \
            analytic_log_gamma_init(k, cfg)


MIX = {"requests": 32, "prompt_len": [65, 256], "gen": [16, 64],
       "arrival": [0, 64]}


def test_rounds_deterministic_per_seed():
    a = requests.make_round(MIX, 2 ** 31 + 3, 0, 50304)
    b = requests.make_round(MIX, 2 ** 31 + 3, 0, 50304)
    assert [(r["uid"], r["gen"], r["arrival"]) for r in a] == \
        [(r["uid"], r["gen"], r["arrival"]) for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))


@pytest.mark.parametrize("seed,index", [(1, 0), (2, 0), (1, 5)])
def test_rounds_hold_one_set_of_shapes(seed, index):
    """Seeds and rounds change token ids and uids, never a request's
    prompt length, budget or arrival."""
    base = requests.make_round(MIX, 0, 0, 100)
    r = requests.make_round(MIX, seed, index, 100)

    def shapes(reqs):
        return [(len(q["prompt"]), q["gen"], q["arrival"]) for q in reqs]
    assert shapes(r) == shapes(base)
    assert sorted(q["uid"] for q in r) == list(range(32 * index,
                                                     32 * index + 32))
    lens = sorted(len(q["prompt"]) for q in r)
    assert lens[0] == 65 and lens[-1] == 256
    assert sorted(q["gen"] for q in r) == list(requests.spread(16, 64, 32))
    assert max(q["arrival"] for q in r) == 63
    assert [q["arrival"] for q in r] == sorted(q["arrival"] for q in r)
    assert not all(np.array_equal(a["prompt"], b["prompt"])
                   for a, b in zip(r, base))


def test_reservoir_is_seeded_and_bounded():
    from bench.harness.sample import Reservoir

    def sample(seed):
        r = Reservoir(3, seed)
        for i in range(100):
            r.offer(i, lambda: i * i)
        return r.kept()
    a = sample(2 ** 31 + 1)
    assert a == sample(2 ** 31 + 1) and len(a) == 3
    assert all(v == k * k for k, v in a.items())
    assert any(sample(s) != a for s in range(5))
