"""``test_torch_train_families.py``'s tests on the audio (hubert-xlarge, E
80, bidirectional, ``frames`` in place of the token embedding) and vlm
(llama-3.2-vision-11b, ``vision_seq`` 70, ``[attn, xattn, attn]``)
families, in a file of their own so that the two halves run on parallel
workers."""
import pytest

from test_torch_train_families import (  # noqa: F401  (collected here too)
    make_arch, one_thread, test_forward_goes_through_the_kernel_functions,
    test_loss_and_gradients_match_jax)


@pytest.fixture(scope="module",
                params=["hubert-xlarge", "llama-3.2-vision-11b"])
def arch(request):
    return make_arch(request.param)
