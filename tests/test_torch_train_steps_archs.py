"""Three train steps of the port against the reference's, by their losses
(rtol 1e-5), with ``accum_steps`` 1 and 2, for the four decoders no other
steps test takes: gemma3-1b and gemma2-27b at 64 tokens (past the reduced
window of 32), mistral-large-123b and grok-1-314b at 16.  The check is
``test_torch_train_steps.check_steps``."""

import pytest

pytest.importorskip("torch")

from test_torch_train_steps import (_one_torch_thread,  # noqa: E402,F401
                                    check_steps)

WINDOW_SEQ = 64     # twice the reduced configs' window


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch,seq", [
    ("gemma3-1b", WINDOW_SEQ), ("gemma2-27b", WINDOW_SEQ),
    ("mistral-large-123b", 16), ("grok-1-314b", 16)])
def test_train_steps_match_the_reference(arch, seq, accum):
    check_steps(arch, accum, seq=seq)
