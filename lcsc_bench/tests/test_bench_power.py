"""The power of the cell's boards from nvidia-smi's lines made by hand:
each board's mean over the window, summed over the cell's boards only."""
import pytest

from lcsc_bench.lib import power

CELL = ["aaaa-0", "bbbb-1", "cccc-2", "dddd-3"]
OTHER = "eeee-4"


def smi(boards, seconds=2.0, step=0.1, t0="2026/10/18 12:00:00.000"):
    """nvidia-smi's lines: every board every ``step`` s, board k drawing
    100 (k + 1) W (200 W more at odd samples) at 1000 + 10 k MHz."""
    import datetime
    start = datetime.datetime.strptime(t0, power.STAMP)
    lines = []
    for i in range(round(seconds / step) + 1):
        stamp = (start + datetime.timedelta(seconds=i * step)).strftime(
            power.STAMP)[:-3]
        for k, b in enumerate(boards):
            lines.append(f"{stamp}, GPU-{b.upper()}, "
                         f"{100.0 * (k + 1) + 200.0 * (i % 2):.2f}, "
                         f"{1000 + 10 * k}")
    return "\n".join(lines) + "\n", start.timestamp()


def sampled(ids, out):
    ps = power.PowerSamples(ids)
    ps.rows = power.parse(out)
    return ps


def test_the_cell_s_boards_are_summed_and_no_other():
    out, t0 = smi(CELL + [OTHER])
    watts, clock, n, boards = sampled(CELL, out).window(t0, t0 + 1.95)
    # 20 samples a board in [t0, t0 + 1.95]: ten at the base draw, ten
    # 200 W above it
    assert n == 20
    assert [b["board"] for b in boards] == CELL
    assert [b["watts"] for b in boards] == pytest.approx(
        [100.0 * (k + 1) + 100.0 for k in range(4)])
    assert watts == pytest.approx(sum(100.0 * (k + 1) + 100.0
                                      for k in range(4)))
    assert clock == pytest.approx(1015.0)
    assert all(b["samples"] == 20 for b in boards)


def test_one_board_reads_the_mean_of_its_samples():
    out, t0 = smi(CELL[:1] + [OTHER])
    watts, clock, n, boards = sampled(CELL[:1], out).window(t0, t0 + 1.95)
    rows = [r for r in power.parse(out) if r[1] == CELL[0]
            and t0 <= r[0] <= t0 + 1.95]
    assert watts == sum(r[2] for r in rows) / len(rows) == 200.0
    assert clock == 1000.0 and n == len(rows) == 20


def test_a_board_with_too_few_samples_fails_the_run():
    out, t0 = smi(CELL)
    few, _ = smi(["ffff-5"], seconds=0.5)
    with pytest.raises(RuntimeError, match="ffff-5"):
        sampled(CELL + ["ffff-5"], out + few).window(t0, t0 + 1.95)


def test_a_board_not_sampled_fails_the_run():
    out, t0 = smi(CELL[:3])
    with pytest.raises(RuntimeError, match=CELL[3]):
        sampled(CELL, out).window(t0, t0 + 1.95)


def test_a_line_not_asked_for_fails():
    with pytest.raises(RuntimeError):
        power.parse("2026/10/18 12:00:00.000, 250.00, 1980\n")


def test_board_ids_compare_alike():
    assert power.board_id("GPU-AbCd-01") == power.board_id("abcd-01")
