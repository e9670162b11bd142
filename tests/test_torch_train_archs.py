"""The training loss and its gradients of the four decoders no other train
test takes, against the reference's, on the CPU at reduced size (float32):
gemma3-1b and gemma2-27b (local and global layers, gemma2's softcaps 50 and
30, tied vocab) at 64 tokens, past the reduced window of 32, so that the
banded path runs forward and backward; mistral-large-123b (GQA) and
grok-1-314b (E 4 / top-2 experts, the fixed-order dispatch backward) at
16.  The check and its tolerances are ``test_torch_train``'s: the loss
within rtol 1e-5, each gradient leaf within 1e-4 of its largest magnitude
plus 1e-6."""

import pytest

pytest.importorskip("torch")

from test_torch_train import (_one_torch_thread,  # noqa: E402,F401
                              check_loss_and_grads)

WINDOW_SEQ = 64     # twice the reduced configs' window


@pytest.mark.parametrize("arch,seq", [
    ("gemma3-1b", WINDOW_SEQ), ("gemma2-27b", WINDOW_SEQ),
    ("mistral-large-123b", 16), ("grok-1-314b", 16)])
def test_loss_and_grads_match_the_reference(arch, seq):
    check_loss_and_grads(arch, seq=seq)
