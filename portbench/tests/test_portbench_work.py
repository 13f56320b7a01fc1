"""The roofline work counts against hand counts at one small shape."""

import pytest

from harness import work


def test_probe_positions():
    assert work.probe_positions(75, 20, True) == 19  # 0, 3, ..., 54
    assert work.probe_positions(75, 20, False) == 56
    assert work.probe_positions(60, 20, True) == 14


def test_seed_work_cuckoo_by_hand():
    # B = 2 reads of L = 23 at k = 20: W = 2, 2 words a read, P = 4
    nbytes, ops = work.seed_work(2, 23, 20, "cuckoo", True, probes=4, hits=3)
    # reads 2*2*4, lens 2*4, nh3 2*4*12; hits 3*(32+8), a miss 64
    assert nbytes == 16 + 8 + 96 + 120 + 64
    # rolling 3*2*23; buckets tried 3 + 2 = 5, each 9*2+6 + 4*2
    assert ops == 138 + 5 * 24 + 5 * 8


def test_seed_work_mphf_by_hand():
    nbytes, ops = work.seed_work(2, 23, 20, "mphf", False, probes=8, hits=5)
    # hits 5*(4+4+8+8), misses 3*4
    assert nbytes == 16 + 8 + 96 + 5 * 24 + 3 * 4
    assert ops == 138 + 8 * 24 + 5 * 2
    with pytest.raises(ValueError):
        work.seed_work(2, 23, 20, "bucket1", False, 8, 5)


def test_walk_work_by_hand():
    nbytes, ops = work.walk_work(2, 23, dc=3, ec_bytes=4, cov_bytes=1,
                                 visits=5, coverage=40)
    # reads 16, lens 8, nh3 rows 24, node rows 240, bases 10,
    # outputs 2*(1+1+4+4+12)
    assert nbytes == 16 + 8 + 24 + 240 + 10 + 44
    assert ops == 240 + 100


def test_least_time_takes_the_longer_bound():
    assert work.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 67e12) == pytest.approx(1.0)
    assert work.least_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_seed_work_at_four_key_words_by_hand():
    # k = 64: W = 4 words a key; B = 2 reads of L = 70, 5 words a read,
    # P = 7 positions
    nbytes, ops = work.seed_work(2, 70, 64, "cuckoo", True, probes=4, hits=3)
    # reads 2*5*4, lens 2*4, nh3 2*7*12; hits 3*(64+8), a miss 2*64
    assert nbytes == 40 + 8 + 168 + 216 + 128
    # rolling 3*2*70; buckets tried 3 + 2 = 5, each 9*4+6 + 4*4
    assert ops == 420 + 5 * 42 + 5 * 16
    nbytes, ops = work.seed_work(2, 70, 64, "mphf", False, probes=8, hits=5)
    # hits 5*(4+4+16+8), misses 3*4; a hash per probe, 4 compares a hit
    assert nbytes == 40 + 8 + 168 + 5 * 32 + 3 * 4
    assert ops == 420 + 8 * 42 + 5 * 4
