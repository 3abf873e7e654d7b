"""``forward_train``'s loss and gradients of reduced whisper-large-v3
(audio), hymba-1.5b (hybrid) and xlstm-350m (ssm) against the
reference, by test_torch_train_families.py's check and tolerances (a
file of their own, to keep each file's time short on one test
worker)."""

import pytest

from test_torch_train_families import HEAVY, check_arch


@pytest.mark.parametrize("arch", HEAVY)
def test_forward_train_matches_the_reference(arch):
    check_arch(arch)
