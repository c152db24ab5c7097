"""The port's TF1 name map (ladder_tpu_torch/utils/tf1_import.py) against
ladder_tpu's: for the three model families and all five priors, the map
over the port model's flax-layout parameters equals the map ladder_tpu
builds over its own parameter tree, key for key (exact)."""

import jax
import pytest

from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.utils.tf1_import import reference_name_map as jmap
from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.utils.tf1_import import reference_name_map
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

FAMILIES = {
    "mnist_digit": dict(num_hidden_units=64),
    "mnist_fashion": dict(exp_name="mnist_fashion", num_hidden_units=64),
    "celeba": dict(exp_name="celeba", dim_input_x=128, dim_input_y=128,
                   dim_input_channel=3, num_hidden_units=16, code_size=8),
}
PRIORS = ("standard_gaussian", "GMM", "ours", "hierarchical", "vampPrior")


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_name_map_is_ladder_tpus(family, prior):
    cfg = make_config(prior=prior, num_hidden_units_inner_VAE=16,
                      n_layers_inner_VAE=3, n_mixtures=4,
                      **FAMILIES[family])
    shapes = jax.eval_shape(jmake(cfg).init, jax.random.PRNGKey(0))
    want = jmap(shapes, cfg)
    got = reference_name_map(make_model(cfg).flax_params(), cfg)
    assert got == want
    assert len(got) > 4


def test_name_map_with_the_decoded_code_std_tower():
    cfg = make_config(prior="ours", num_hidden_units=64,
                      num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                      TRAIN_decoded_z_std=1)
    shapes = jax.eval_shape(jmake(cfg).init, jax.random.PRNGKey(0))
    got = reference_name_map(make_model(cfg).flax_params(), cfg)
    assert got == jmap(shapes, cfg)
    assert any("prior/dense_9/" in name for name in got)


def test_an_unknown_leaf_has_no_name():
    cfg = make_config()
    with pytest.raises(KeyError, match="no TF1 naming rule"):
        reference_name_map({"encoder": {"Mystery_0": {"kernel": 0}}}, cfg)
