"""The reference's TF1 variable names for the port's parameters (the name
map of ``ladder_tpu/utils/tf1_import.py``, its :49-151).

The reference trains with two ``tf.train.Saver``s, 'vae-model' and
'prior-model' (codes/base.py:37-65). ``reference_name_map`` names the TF1
variable of every leaf of a flax-layout parameter tree, the tree that
``model.flax_params()`` (utils/weights.py:torch_to_flax) gives: TF1's
auto-naming rules (``tf.layers.dense`` numbers unnamed layers ``dense``,
``dense_1``, ... per scope and type; explicitly named layers keep their
names) over the three model families, the inner VAE, the vampPrior
pseudo-inputs and the CelebA StyleMod and batch-norm variables. The
layouts need no transpose: TF dense kernels are [in, out] and conv kernels
[kH, kW, in, out], as in the flax tree.

Reading or writing a TF1 checkpoint needs TensorFlow and is not ported.
"""

from __future__ import annotations

from ladder_tpu_torch.utils.checkpoint import PRIOR_KEYS, VAE_KEYS

GROUP_FILES = (("vae-model", VAE_KEYS), ("prior-model", PRIOR_KEYS))


def _sfx(i):
    """TF1's uniquifying suffix: the first layer of a type is bare, then
    _1, _2, ..."""
    return "" if i == 0 else f"_{i}"


def _tf1_name(path, config):
    """The reference's variable name for one leaf path of the grouped
    parameter tree, e.g. ('decoder', 'style_mod_0', 'style', 'kernel').
    Raises KeyError for a path no rule covers."""
    group = path[0]
    if group == "sigma":
        return "sigma/Variable"
    if group == "inner_sigma":
        return "inner_sigma/Variable"
    leaf = path[-1]

    if group in ("encoder", "decoder"):
        mod = path[1]
        if mod.startswith("Conv_"):
            name = "conv2d" + _sfx(int(mod[len("Conv_"):]))
        elif mod.startswith("Dense_"):
            name = "dense" + _sfx(int(mod[len("Dense_"):]))
        elif mod.startswith("dlatent_"):
            # the CelebA mapping net is created right after the input dense
            # (models.py:501-510), so dlatent_i is the (i+1)-th dense
            name = "dense" + _sfx(int(mod[len("dlatent_"):]) + 1)
        elif mod.startswith("BatchNormTrain_"):
            name = ("batch_normalization"
                    + _sfx(int(mod[len("BatchNormTrain_"):])))
        elif mod.startswith("style_mod_"):
            # StyleMod_N opens its own scope with one dense inside
            # (modules.py:6-10); the tree's subtree is style_mod_N/style
            name = f"StyleMod_{int(mod[len('style_mod_'):])}/dense"
        elif mod in ("code_mean", "code_std_dev"):
            name = mod
        else:
            raise KeyError(f"no TF1 naming rule for {'/'.join(path)}")
        return f"{group}/{name}/{leaf}"

    if group == "prior":
        sub, mod = path[1], path[2]
        if sub == "vamp":
            # a tf.Variable under the scope 'prior' (base.py:224-225)
            return "prior/Variable"
        n = config["n_layers_inner_VAE"]
        if sub == "inner_encoder":
            if mod.startswith("enc_"):
                i = int(mod[len("enc_"):])
            elif mod == "representation_mean":
                i = n
            elif mod == "representation_std_dev":
                i = n + 1
            else:
                raise KeyError(f"no TF1 naming rule for {'/'.join(path)}")
        elif sub == "inner_decoder":
            if mod.startswith("dec_std_"):
                i = 2 * n + 3 + int(mod[len("dec_std_"):])
            elif mod.startswith("dec_"):
                i = n + 2 + int(mod[len("dec_"):])
            elif mod == "decoded_code":
                i = 2 * n + 2
            elif mod == "decoded_code_std":
                i = 3 * n + 3
            else:
                raise KeyError(f"no TF1 naming rule for {'/'.join(path)}")
        else:
            raise KeyError(f"no TF1 naming rule for {'/'.join(path)}")
        return f"prior/dense{_sfx(i)}/{leaf}"

    raise KeyError(f"no TF1 naming rule for {'/'.join(path)}")


def _flatten_with_paths(params, prefix=()):
    """[(path tuple, leaf)] over nested dicts, keys sorted at every level
    (the order of ``jax.tree_util.tree_flatten_with_path``)."""
    if not isinstance(params, dict):
        return [(prefix, params)]
    out = []
    for key in sorted(params):
        out.extend(_flatten_with_paths(params[key], prefix + (key,)))
    return out


def reference_name_map(params, config):
    """{tf1_variable_name: leaf path tuple} over the whole parameter tree
    (any leaves: only the paths are read)."""
    mapping = {}
    for path, _ in _flatten_with_paths(params):
        name = _tf1_name(path, config)
        if name in mapping:
            raise ValueError(
                f"TF1 name collision: {name} from {'/'.join(path)} and "
                f"{'/'.join(mapping[name])}")
        mapping[name] = path
    return mapping
