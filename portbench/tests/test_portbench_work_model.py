"""The roofline's work model: counts that repeat, hand-checked at the
b64_m1_x256 and b64_m4_x64 verify shapes and the two prove shapes."""

import math

from portbench.harness import work_model as wm

TARI = {"bits": 64, "extension_degree": 1}
AGG = {"bits": 64, "extension_degree": 5}


def test_portbench_pippenger_window_is_the_cheapest():
    for n in (1, 3, 130, 4226, 5000):
        best = min(math.ceil(253 / c) * (n + 2 ** (c + 1)) for c in range(1, 21))
        assert wm.pippenger_adds(n) == best
    # 4,226 points: c = 8 gives 32 * (4226 + 512) = 151,616 additions (c = 9: 152,250)
    assert wm.pippenger_adds(4226) == 32 * (4226 + 512)


def test_portbench_verify_block_b64_m1_x256():
    ops, nbytes = wm.verify_block_ops(TARI, [1] * 256)
    # MSM: 128 generators, H, G_1 and 256 x (1 commitment, A, A1, B, 6 L, 6 R) = 4,226 points
    msm = 32 * (4226 + 512) * 7 * 64 + 253 * (4 * 64 + 4 * 36)
    decode = 256 * 15 * (250 * 36 + 11 * 64)
    scalars = 256 * (4 * 64 + 3 * 8) * 64
    assert ops == msm + decode + scalars == wm.verify_block_ops(TARI, [1] * 256)[0]
    assert nbytes == 256 * (1 + 32 * 18 + 32) + 64 * 128
    assert wm.verify_block_s(TARI, [1] * 256) == ops / 16.7e12


def test_portbench_verify_block_b64_m4_x64():
    ops, _ = wm.verify_block_ops(AGG, [4] * 64)
    points = 2 * 256 + 1 + 5 + 64 * (4 + 3 + 16)
    assert points == 1990
    best = min(math.ceil(253 / c) * (1990 + 2 ** (c + 1)) for c in range(1, 21))
    msm = best * 7 * 64 + 253 * (4 * 64 + 4 * 36)
    assert ops == msm + 64 * 19 * (250 * 36 + 11 * 64) + 64 * (4 * 256 + 3 * 10) * 64


def test_portbench_prove_calls():
    ops, nbytes = wm.prove_call_ops(TARI, 128, 1)
    one = 64 * 7 * 64 + wm.msm_ops(2)
    one += sum(2 * wm.msm_ops(2 * n + 2) for n in (32, 16, 8, 4, 2, 1))
    one += wm.msm_ops(4) + wm.msm_ops(2) + 15 * (250 * 36 + 11 * 64) + (3 * 64 + 6 * 63) * 64
    assert ops == 128 * one
    assert nbytes == 128 * (1 + 32 * 18 + 8 + 32)
    ops4, _ = wm.prove_call_ops(AGG, 64, 4)
    assert ops4 > 2 * ops / 2  # 64 proofs at mn 256 against 128 at mn 64
    assert wm.prove_call_s(AGG, 64, 4) == ops4 / 16.7e12
