"""K3's entry with n_total (csrc/update.cu bg_grads_stats), on the card.

A data-parallel rank runs K3 on its rows with the global row count as
n_total, so that the ranks' gradients summed are the whole batch's.  At
n_total = n the call is the one without it, bitwise; at n_total = 2n the
loss means' factor 1/n_total and the bound term's scale halve exactly
(scaling by a power of two commutes with rounding), every later product
is linear in them, so g halves exactly, while the metric sums, mu and logp
do not move.  The tests are marked `cuda` and skip without a card; the CPU
side of the same arithmetic is tests/test_torch_parallel.py (K3's plain
version over two halves).  This file imports nothing of JAX (`pytest
--noconftest -m cuda` runs it on the card).
"""

import pytest
import torch

from booster_gym_torch.testing import update_case


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def k3_args(dtype, T, B, gpu):
    fused, p, staged, prep, d = update_case(dtype, T, B, gpu, seed=5)
    adv = d["adv"]
    mean, rstd = adv.mean(), 1.0 / (adv.std() + 1e-8)
    return fused, (staged, p, prep, adv, d["ret"], mean, rstd, False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("T,B", [(24, 4096), (24, 1000)])
def test_k3_at_its_own_row_count_is_the_call_without_n_total(gpu, dtype, T, B):
    fused, args = k3_args(dtype, T, B, gpu)
    g, st, mu, logp = fused.grads_stats(*args)
    g2, st2, mu2, logp2 = fused.grads_stats(*args, n_total=T * B)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(mu, mu2) and torch.equal(logp, logp2)
    assert all(torch.equal(st[k], st2[k]) for k in st)
    assert fused.grads_stats_launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k3_at_twice_its_row_count_halves_the_gradient(gpu, dtype):
    T, B = 24, 2048
    fused, args = k3_args(dtype, T, B, gpu)
    g, st, mu, logp = fused.grads_stats(*args)
    g2, st2, mu2, logp2 = fused.grads_stats(*args, n_total=2 * T * B)
    torch.cuda.synchronize()
    assert torch.equal(g2 * 2.0, g)
    assert torch.equal(mu, mu2) and torch.equal(logp, logp2)
    assert all(torch.equal(st[k], st2[k]) for k in st)
    # and its plain version does the same on the card's inputs
    gp = fused.grads_stats_plain(*args)[0]
    gp2 = fused.grads_stats_plain(*args, n_total=2 * T * B)[0]
    assert torch.equal(gp2 * 2.0, gp)
