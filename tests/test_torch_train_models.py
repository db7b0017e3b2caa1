"""One float32 train step of zamba2-7b (Mamba-2 and the shared attention
block), falcon-mamba-7b (Mamba-1, the plain scan on the CPU) and
whisper-tiny (the encoder-decoder over frames, cross attention) against
the reference's, as tests/test_torch_train_step.py holds the dense and MoE
models (`check_step`: the same tolerances)."""
import pytest
import torch
from test_torch_train_step import check_step

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["zamba2-7b", "falcon-mamba-7b", "whisper-tiny"])
def test_one_fp32_step_matches_reference(arch):
    check_step(arch)
