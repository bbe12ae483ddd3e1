"""T1, the elementwise-throughput probe: the port's plain version against
the JAX tool's Pallas kernel in interpret mode, on the CPU.

``tools/vpu16.py`` is run as it is, with its module constants ``B``,
``W`` and ``STEPS`` patched to 8, 128 and 48 and ``pl.pallas_call``
wrapped to interpret: at 48 steps of 16 rounds the int16 ``add`` wraps
(769 x 49 > 32767) and the int8 ``add`` wraps at once, and the bf16
``add`` stops growing where ``b`` falls under half an ulp.  The two must
agree exactly (tolerance 0, bf16 included) on inputs drawn from one
numpy seed.  The CUDA kernel itself runs only on a card
(``chip_smoke.py`` phase 15).
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from exonerate_tpu_torch.tools import vpu16

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, W, STEPS = 8, 128, 48
_JNP = {torch.int32: jnp.int32, torch.int16: jnp.int16,
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.int8: jnp.int8}


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_vpu16", os.path.join(ROOT, "tools", "vpu16.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 50, (B, W))


@pytest.mark.parametrize("dtype, mix", vpu16.CASES,
                         ids=[vpu16.case_name(d, m).replace(" ", "")
                              for d, m in vpu16.CASES])
def test_plain_equals_the_jax_tool_in_interpret_mode(jax_tool, monkeypatch,
                                                     dtype, mix):
    monkeypatch.setattr(jax_tool, "B", B)
    monkeypatch.setattr(jax_tool, "W", W)
    monkeypatch.setattr(jax_tool, "STEPS", STEPS)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x = _x(7)
    fn, opi = jax_tool.build(_JNP[dtype], mix)
    want = np.asarray(fn(jnp.asarray(x, _JNP[dtype])).astype(jnp.float32))
    got = vpu16.plain(torch.tensor(x, dtype=dtype), mix, STEPS,
                      jax_tool.ITERS)
    assert opi == vpu16.OPS_PER_ITER[mix]
    assert got.dtype == dtype and tuple(got.shape) == (B, W)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper runs the plain version for a CPU tensor
    assert torch.equal(vpu16.vpu16(torch.tensor(x, dtype=dtype), mix,
                                   STEPS, jax_tool.ITERS), got)
    if mix == "add" and dtype in (torch.int16, torch.int8):
        # wrapped: 1 + 48 x 16 adds of x, not the int64 sum
        assert (got.long().numpy() != x * 769).any()


def test_build_raises_without_a_card(monkeypatch):
    """build() needs a card and never falls back to the plain version;
    the wrapper refuses a case the kernel does not have."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        vpu16.build(torch.int32, "mix")
    with pytest.raises(ValueError, match="no case"):
        vpu16.vpu16(torch.ones(4, dtype=torch.int8), "mix")
    with pytest.raises(ValueError, match="multiple"):
        vpu16.vpu16(torch.ones(4, dtype=torch.int32), "add", 3, 5)


def test_bound_and_peaks():
    """The bound counts the JAX tool's element operations over the peak of
    the instruction the case issues: 128 instructions a clock per SM
    times the lanes each computes (int32, int16 and float32 one, bf16x2
    two, int8's packed add four)."""
    ops = B * W * STEPS * 16 * 6
    assert vpu16.n_ops("mix", B * W, STEPS) == ops
    assert vpu16.bound_ms(torch.int32, "mix", B * W, STEPS) == \
        pytest.approx(ops / (128 * 132 * 1.98e9) * 1e3)
    assert vpu16.bound_ms(torch.bfloat16, "mix", B * W, STEPS) == \
        pytest.approx(ops / (256 * 132 * 1.98e9) * 1e3)
    assert vpu16.bound_ms(torch.int8, "add", B * W, STEPS) == \
        pytest.approx(ops / 6 / (512 * 132 * 1.98e9) * 1e3)
    assert vpu16.peak_ops_s(torch.bfloat16) == \
        2 * vpu16.peak_ops_s(torch.int16)
    assert vpu16.peak_ops_s(torch.int8) == 4 * vpu16.peak_ops_s(torch.int32)
    assert vpu16.peak_ops_s(torch.float32) == \
        vpu16.peak_ops_s(torch.int16)
    for dtype in vpu16.LANES:
        assert vpu16.PEAK_PER_SM_CLOCK[dtype] == 128 * vpu16.LANES[dtype]
    # a 32-bit register of bf16 or int8 lanes; int16 unpacked (no .s16x2
    # add, sub or compare on the card)
    assert (vpu16.LANES[torch.bfloat16], vpu16.LANES[torch.int8],
            vpu16.LANES[torch.int16]) == (2, 4, 1)


def test_wrapper_fills_whole_registers():
    """A register holds LANES elements: the wrapper refuses a tensor that
    does not fill its last one."""
    with pytest.raises(ValueError, match="registers"):
        vpu16.vpu16(torch.ones(6, dtype=torch.int8), "add", 4, 16)
    assert torch.equal(vpu16.vpu16(torch.ones(8, dtype=torch.int8), "add",
                                   4, 16), torch.full((8,), 65, dtype=torch.int8))


def test_issued_reads_the_case_from_the_sass_counts():
    """issued() picks a case's instantiation by its template arguments
    and counts the element slots its instructions compute, NOPs aside:
    instructions times the lanes each one computes, against counted(),
    the ops of UNROLL rounds of a register's elements."""
    from collections import Counter
    counts = {"_Z12vpu16_kernelILi0ELi1EEvPKi": Counter(IADD3=300, NOP=9),
              "_Z12vpu16_kernelILi0ELi0EEvPKi": Counter(IADD3=64, BRA=3),
              "_Z12vpu16_kernelILi3ELi1EEvPKj": Counter(HADD2=400, NOP=2),
              "_Z12vpu16_kernelILi4ELi0EEvPKj": Counter(LOP3=192,
                                                        IADD3=70)}
    assert vpu16.issued(counts, torch.int32, "mix") == 300
    assert vpu16.issued(counts, torch.int32, "add") == 67
    assert vpu16.issued(counts, torch.bfloat16, "mix") == 800
    assert vpu16.issued(counts, torch.int8, "add") == 4 * 262
    assert vpu16.counted(torch.int32, "mix") == 6 * 64
    assert vpu16.counted(torch.bfloat16, "mix") == 2 * 6 * 64
    assert vpu16.counted(torch.int16, "mix16") == 6 * 64
    assert vpu16.counted(torch.int8, "add") == 4 * 64
    with pytest.raises(RuntimeError, match="instantiations"):
        vpu16.issued(counts, torch.int16, "add")
