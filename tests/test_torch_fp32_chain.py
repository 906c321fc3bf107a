"""The FP32 issue-peak probe's plain version (kernels/fp32_chain.py::
chain_reference) against the JAX package's ``_chain_kernel``
(scripts/vpu_roofline.py:56-87) in a Pallas call built as ``build_chain``
builds it, in interpret mode on the CPU, both legs.

Tolerances: the add leg bitwise (both sides round every sum in float32,
in the same order). The FMA leg within rtol 1e-5, the tolerance the card
check uses: XLA's CPU compiler contracts acc * c + d into one fused
multiply-add, as the CUDA kernel does, while the plain version rounds the
product and the sum; over the 3 x 16 steps of a chain near 1 the two differ
by up to 2.3e-6 relative (measured).
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scripts.vpu_roofline as vpu_roofline  # noqa: E402
from assistedmanipulation_tpu_torch.kernels import fp32_chain  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

GRID = 2
ITERATIONS = 3


def _jax_chain(x, accumulators, fma):
    """One launch of the JAX microkernel (vpu_roofline.build_chain without
    its REPS chaining), interpret mode, on (GRID, 8, 128) tiles."""
    kernel = functools.partial(
        vpu_roofline._chain_kernel, iterations=ITERATIONS, accumulators=accumulators, fma=fma
    )
    call = pl.pallas_call(
        kernel,
        grid=(GRID,),
        in_specs=[pl.BlockSpec((None, 8, 128), lambda g: (g, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((None, 8, 128), lambda g: (g, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((GRID, 8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((accumulators, 8, 128), jnp.float32)],
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(x)))


@pytest.mark.parametrize("fma", [True, False])
@pytest.mark.parametrize("accumulators", [1, 4])
def test_chain_reference_matches_jax_chain_kernel(fma, accumulators):
    assert vpu_roofline.UNROLL == fp32_chain.UNROLL
    x = (1.0 + 1e-3 * np.random.default_rng(accumulators).random((GRID, 8, 128))).astype(np.float32)
    want = _jax_chain(x, accumulators, fma)
    got = fp32_chain.chain(torch.tensor(x.ravel()), ITERATIONS, accumulators, fma).numpy()
    assert np.isfinite(want).all()
    if fma:
        np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("fma", [True, False])
@pytest.mark.parametrize("accumulators", [1, 16])
def test_chain_check_catches_a_chain_one_step_short(fma, accumulators):
    """The rule the card's check applies (compare_to_reference, on the
    inputs chip_smoke.py gives it) rejects a chain that skips a single step
    of every accumulator, on either leg, and accepts the full chain."""
    x = 1.0 + 0.001 * torch.rand(4096, generator=torch.Generator().manual_seed(12))
    k = fp32_chain.CHECK_ITERATIONS
    want = fp32_chain.chain_reference(x, k, accumulators, fma)
    fp32_chain.compare_to_reference(want.clone(), want, fma)
    short = fp32_chain.chain_reference(x, k * fp32_chain.UNROLL - 1, accumulators, fma, unroll=1)
    with pytest.raises(AssertionError):
        fp32_chain.compare_to_reference(short, want, fma)


def test_chain_wrapper_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no FP32 chain kernel"):
        fp32_chain.chain(torch.ones(8, device="meta"), 1, 1, True)


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_117fp32_chain_kernelILi2ELi2ELb1EEEvPKfPfii
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe20000000800 */
        /*0010*/                   FFMA R4, R0, 0.001, R2 ;                /* 0x000... */
        /*0020*/                   FFMA R5, R5, R3, R6 ;
        /*0030*/                   FFMA R5, R5, R3, R6 ;
        /*0040*/                   IADD3 R7, R7, 0x1, RZ ;
        /*0050*/                   FFMA R4, R4, R3, R6 ;
        /*0060*/                   FFMA R4, R4, R3, R6 ;
        /*0070*/                   ISETP.GE.AND P0, PT, R7, c[0x0][0x214], PT ;
        /*0080*/              @!P0 BRA 0x20 ;
        /*0090*/                   FADD R4, R4, R5 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_117fp32_chain_kernelILi1ELi1ELb0EEEvPKfPfii
        /*0000*/                   FADD R4, R0, R2 ;
.L_x_0:
        /*0010*/                   FADD R4, R4, R6 ;
        /*0020*/                   IADD3 R7, R7, 0x1, RZ ;
        /*0030*/              @P0 BRA `(.L_x_0) ;
        /*0040*/                   EXIT ;
"""


def test_sass_loop_counts_read_the_loop_body():
    """The SASS reader counts only the instructions between a backward
    branch and its target, with hex or label targets."""
    assert fp32_chain.loop_instruction_counts(SASS) == {(2, 2, True): (4, 0), (1, 1, False): (0, 1)}
