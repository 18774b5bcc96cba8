"""The roofline byte counts against hand-computed shapes."""

import numpy as np

from benchmark import roofline


def test_k1_bytes_disjoint_windows():
    # 2 rows, 2 slots, windows far apart: 2 x 2 windows of 256 int32 samples
    # read, 4 positions in, 4 windows of 256 uint16 out
    pos = np.array([[1000, 5000], [1000, 9000]])
    assert roofline.k1_bytes(pos, 131310) == 4 * 4 * 256 + 4 * 4 + 4 * 256 * 2


def test_k1_bytes_overlapping_and_padded_windows():
    # windows at 1000 and 1100 share 156 samples; two padded slots at the
    # scan length cover the row's last 241 samples once; a window at 0
    # starts one sample before the row (lead 1) and reads 255
    s = 131310
    pos = np.array([[0, 1000, 1100, 131070, 131070]])
    covered = 255 + (256 + 100) + (s - 131069)
    assert roofline.k1_bytes(pos, s) == 4 * covered + 4 * 5 + 5 * 256 * 2


def test_k1_bytes_clamps_starts_past_the_padded_row():
    # a start past s_pad - 256 is clamped there, then lies outside the row
    s = 1000
    s_pad = roofline.k1_s_pad(s)
    assert s_pad == 4096
    pos = np.array([[s_pad + 50]])
    assert roofline.k1_bytes(pos, s) == 4 * 0 + 4 + 512


def test_k2_bytes():
    # 512 rows x 256 slots: 16 B in and 4 B out a slot, 4 B a row, the
    # 1,024-entry cache (addresses and times) in and out
    assert roofline.k2_bytes(512, 256) == 512 * 256 * 20 + 512 * 4 + 4 * 4 * 1024


def test_share_pct():
    # 3.35 GB in 1 ms on a 3.35 TB/s card is 100%
    assert abs(roofline.share_pct(3.35e9, 1e-3, "NVIDIA H100 80GB HBM3") - 100.0) < 1e-9
    assert roofline.share_pct(1, 0.0, "x") is None
