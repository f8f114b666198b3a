"""The work counts against counts made by hand."""
import pytest

from lcsc_bench.lib import counts


def test_hop_per_site():
    # 1320 flops; 8 links of 18 reals, a spinor in and a spinor out
    assert counts.HOP_FLOPS == 1320
    assert counts.HOP_REALS == 192
    assert counts.hop_bytes(2, "float32") == 768
    assert counts.hop_bytes(2, "bfloat16") == 384
    # 32^3 x 8: 131072 half-sites, 100.66 MB at f32
    assert counts.hop_bytes(32 ** 3 * 8, "float32") == 100_663_296


def test_solve_counts_by_hand():
    half = 8 ** 4 // 2
    # a CG iteration: 4 hops, 2 Schur axpys, 2 dots and 3 updates
    per_iter = 4 * 1320 + 2 * 48 + 5 * 48
    fixed = 2 * (1320 + 48) + (2 * 1320 + 48)
    assert counts.solve_flops(8 ** 4, 17) == half * (17 * per_iter + fixed)
    reals_iter = 4 * 192 + 2 * 72 + (2 + 1 + 9) * 24
    reals_fixed = 2 * (192 + 72) + (2 * 192 + 72)
    assert counts.solve_bytes(8 ** 4, 17, "bfloat16", "float32") == \
        half * (17 * reals_iter * 2 + reals_fixed * 4)


@pytest.mark.parametrize("n", [256, 1024, 32768])
def test_hpl_flops(n):
    assert counts.hpl_flops(n) == pytest.approx(2 / 3 * n ** 3 + 1.5 * n ** 2)


def test_update_flops_sum_over_steps():
    n, nb = 1024, 128
    ups = counts.hpl_updates(n, nb, lookahead=1)
    # steps 1..7: the next panel's 128 columns, then the rest if any
    assert len(ups) == 2 * (n // nb) - 3
    by_hand = sum(2 * nb * (n - k1) ** 2 for k1 in range(nb, n, nb))
    assert sum(counts.gemm_flops(*u) for u in ups) == by_hand
    # without lookahead: one update a step, the same flops
    plain = counts.hpl_updates(n, nb, lookahead=0)
    assert len(plain) == n // nb - 1
    assert sum(counts.gemm_flops(*u) for u in plain) == by_hand
    # the cell's: 509 launches at n = 65536, nb = 256
    assert len(counts.hpl_updates(65536, 256, 1)) == 509


def test_gemm_bytes():
    assert counts.gemm_bytes(4, 2, 3) == 4 * (2 * 12 + 8 + 6)
