"""Shared pieces of the benchmark's CPU tests: a tiny run of a cell on the
CPU, through the port's plain PyTorch versions of its kernels."""

import sys

import pytest

# a unit of ~170 variants and 4 samples, short chains: seconds on the CPU
TINY_SETTINGS = {"num_chains": 4, "burn_in": 10, "num_samples": 30,
                 "num_host_threads": 2}
TINY_CONFIG = {"mix_scale": 0.02, "samples": 4}
# no duplicated block: at this scale it would be most of the genome
TINY_MIX = {"dup_block": 0}


# the tiny unit with one 7-SNV family (H128, past the gather path's 65; the
# port's plain CPU path at H256 peaks at ~10 GB): the configuration states
# the judge's reach past it and the sample blooms that raise the cluster
# phase's path limit from 128 to 512 (4 samples)
DENSE_MIX = {"kinds": {"snv": 5200, "indel": 800, "dense2": 600,
                       "dense4": 250, "dense6": 60, "dense7": 50,
                       "sv_del": 70, "sv_ins": 50}}
DENSE_CONFIG = {"judge": {"max_haplotypes": 1025},
                "cluster": {"max_parameter_kmers": 1000000,
                            "sample_blooms": True}}


def tiny_run(cell="r3-bulk-seq", seed=2**33 + 5, settings=None, config=None,
             mix=None, program=None):
    from portbench import run

    return run.run_cell(
        cell, seed, 0.0, False, device="cpu",
        settings=dict(TINY_SETTINGS, **(settings or {})),
        config=dict(TINY_CONFIG, **(config or {})),
        mix=dict(TINY_MIX, **(mix or {})), warm=False,
        log=lambda m: print(m, file=sys.stderr), program=program)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
