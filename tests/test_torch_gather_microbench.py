"""M, the gather microbenchmark: the port's plain version against the
Pallas kernel of ``benchmarks/gather_microbench.py`` run in interpret
mode, both TPU gather strategies, bit for bit. The JAX file is loaded from
its path, as it stands. Block 0 of the port's output is the TPU kernel's
result; block b is the TPU kernel's at seed + b."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu_torch.benchmarks import gather_microbench as gm

EVENTS = 8


@pytest.fixture(scope="module")
def jgm():
    path = Path(__file__).resolve().parent.parent / "benchmarks" / \
        "gather_microbench.py"
    spec = importlib.util.spec_from_file_location("jax_gather_microbench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("C", [32, 256])
@pytest.mark.parametrize("variant", ["sweep", "matmul_sub"])
def test_gather_plain_matches_pallas(jgm, variant, C):
    table, tt = jgm._tables(C)
    np.testing.assert_array_equal(gm.make_table(C), table)
    fn = jgm.make_fn(variant, C, EVENTS, interpret=True)
    out = gm.gather_plain(torch.as_tensor(table), 5, C, EVENTS, blocks=2)
    assert tuple(out.shape) == (2, 8, 128)
    for b in range(2):
        ref = np.asarray(fn(table, tt, np.asarray([5 + b], np.int32)))
        np.testing.assert_array_equal(out[b].numpy(), ref)


def test_gather_wrapper_takes_plain_on_cpu():
    """A table on the CPU takes the plain version and launches nothing;
    shapes and sizes the kernel does not take raise."""
    table = torch.as_tensor(gm.make_table(32))
    before = dict(gm.LAUNCHES)
    for variant in gm.VARIANTS:
        out = gm.gather(table, 3, 32, 4, 1, variant)
        assert torch.equal(out, gm.gather_plain(table, 3, 32, 4, 1))
    assert gm.LAUNCHES == before
    with pytest.raises(ValueError):
        gm.gather(table, 3, 48, 4)
    with pytest.raises(ValueError):
        gm.gather(table, 3, 32, 4, variant="texture")
