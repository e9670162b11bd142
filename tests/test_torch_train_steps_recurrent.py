"""Three train steps of the port against the reference's, by their losses
(rtol 1e-5), for the Mamba (falcon-mamba-7b) and Griffin
(recurrentgemma-9b) archs at reduced size, with ``accum_steps`` 1 and 2:
the plain selective scan and RG-LRU loop under autograd.  The check is
``test_torch_train_steps.check_steps``; this file keeps each under a
minute on one worker."""

import pytest

pytest.importorskip("torch")

from test_torch_train_steps import check_steps  # noqa: E402


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_train_steps_match_the_reference(arch, accum):
    check_steps(arch, accum)
