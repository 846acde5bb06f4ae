"""``test_torch_train.py``'s tests on the other two dense archs, gemma-7b
(gated tanh-gelu, E 256 in the full config) and h2o-danube-1.8b (its
reduced window of 32 bites at 40 tokens), in a file of their own so that
the two halves run on parallel workers."""
import pytest

from test_torch_train import (  # noqa: F401  (collected here as well)
    make_arch, one_thread, test_forward_goes_through_the_kernel_functions,
    test_loss_and_gradients_match_jax)


@pytest.fixture(scope="module", params=["gemma-7b", "h2o-danube-1.8b"])
def arch(request):
    return make_arch(request.param)
