"""The training losses and every gradient leaf against ``jax.grad`` on
``reduced()`` configs of the other archs (d_model 64, fp32, rtol 1e-4 /
atol 1e-5): granite-moe-3b-a800m (4 experts top-2: the load-balancing term
of every loss) and recurrentgemma-2b (RG-LRU states and a sliding-window
cache, the state paths that autograd could not cross while caches were
written in place), every loss; internvl2-76b (mixed input: prefix
embeddings stripped from the CE, and offsetting Eq. 7's target) and
seamless-m4t-medium (enc-dec: the encoder, and the cross cache the base's
prefill fills) through ``train_loss`` and Eq. 7 at share ratio 0.5. The
helpers and the dense config are in tests/test_torch_train_losses.py.
"""
import pytest

from test_torch_train_losses import LOSSES, check_loss_and_grads


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("name", ["moe", "recurrent"])
def test_loss_and_every_grad_leaf_match_reference(name, loss):
    check_loss_and_grads(name, loss)


@pytest.mark.parametrize("loss", ["train", "cc0.5"])
@pytest.mark.parametrize("name", ["mixed", "encdec"])
def test_input_embeds_losses_match_reference(name, loss):
    check_loss_and_grads(name, loss)
