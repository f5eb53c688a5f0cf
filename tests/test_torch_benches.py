"""bench_lj_torch.py and bench_chain_torch.py need a GPU: without one each
raises before it builds anything, instead of timing the CPU; their
constants are bench_lj.py's and bench_chain.py's."""
import pytest
import torch

import bench_chain_torch
import bench_lj_torch
import bench_torch


@pytest.mark.parametrize("bench", [bench_lj_torch, bench_chain_torch])
def test_bench_raises_without_a_gpu(bench):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the bench would run")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench.main()


def test_bench_sizes():
    assert bench_lj_torch.NX == bench_chain_torch.NX == 20
    assert bench_torch.NSTEPS == 400
    assert bench_lj_torch.production is bench_chain_torch.production \
        is bench_torch.production
