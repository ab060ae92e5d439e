"""Shared set-up of the port's differential tests (tests/test_torch_*.py):
one small configuration for both packages, JAX parameters with informative
random values, and moving-blob voxel clips. Everything is made from numpy
seeds and handed to both sides."""
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from neural_marionette_tpu.config import MarionetteConfig as JaxConfig
from neural_marionette_tpu.models import NeuralMarionette as JaxMarionette
from neural_marionette_tpu.models import SkeletonArrays as JaxSkeletonArrays
from neural_marionette_tpu.ops import voxelize_np

import torch

from neural_marionette_tpu_torch.config import MarionetteConfig

# The suite runs in several worker processes at once. With its default of
# one intra-op thread per core, each PyTorch process oversubscribes the CPU
# and its waiting threads slow every worker down many times over.
torch.set_num_threads(1)

SMALL = dict(grid_size=32, feat_dim=32, nkeypoints=6, Ttot=4, Tcond=2,
             input_dim=3, nlatent_kypt=16, nhidden_kypt=32)


def configs(**kw):
    """(JAX config, port config) with the same fields."""
    jcfg = JaxConfig(**{**SMALL, **kw})
    return jcfg, MarionetteConfig(**dataclasses.asdict(jcfg))


def randomize(params, seed=0):
    """Informative random values for every leaf of a JAX parameter tree
    (arrays, or the ``ShapeDtypeStruct``s of ``jax.eval_shape``): conv and
    dense kernels N(0, 1/fan_in), biases N(0, 0.05), GroupNorm scales
    1 + N(0, 0.1), affinity params N(0, 1); the dynamics' linears and GRU
    uniform(+-1/sqrt(fan_in)), their initial state and offset directions
    N(0, 1), as the JAX package initialises them."""
    g = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path).rpartition("['")[2][:-2]
        shape = tuple(x.shape)
        if name in ("kernel", "propagate_kernel"):
            sd = 0.7 if name == "propagate_kernel" else \
                int(np.prod(shape[:-1])) ** -0.5
            v = g.normal(0, sd, shape)
        elif name in ("bias", "propagate_bias"):
            v = g.normal(0, 0.05, shape)
        elif name == "scale":
            v = 1 + g.normal(0, 0.1, shape)
        elif name in ("affinity_params", "init_kypt_rnn_state",
                      "offset_param"):
            v = g.normal(0, 1, shape)
        elif name.startswith("gru_"):
            bound = shape[-1] // 3 if name.startswith("gru_w") else \
                shape[0] // 3
            v = g.uniform(-1, 1, shape) * bound ** -0.5
        elif name.endswith("_w") or name.endswith("_b"):
            fan_in = params_fan_in[name[:-2]]
            v = g.uniform(-1, 1, shape) * fan_in ** -0.5
        else:
            raise KeyError(f"no random rule for parameter {name}")
        return v.astype(np.float32)

    params_fan_in = {}
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax.tree_util.keystr(path).rpartition("['")[2][:-2]
        if name.endswith("_w") and not name.startswith("gru_"):
            params_fan_in[name[:-2]] = x.shape[0]
    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_params(jcfg, seed=0):
    """The JAX model and random parameters for it, as numpy arrays; only
    the shapes come from its ``init``."""
    model = JaxMarionette(jcfg)
    g = jcfg.grid_size
    example = jnp.zeros((1, 2, g, g, g, 1), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(seed),
         "sample": jax.random.PRNGKey(seed + 1)},
        example, detector_active=True, learner_active=True,
        skeleton=JaxSkeletonArrays.chain(jcfg.nkeypoints)))
    return model, randomize(shapes, seed)


def moving_vox(B=2, T=4, G=32, n=384, seed=0):
    """(B, T, G, G, G, 1) clips of coherently moving point blobs (the
    velocity-cosine graph loss needs well-conditioned keypoint motion)."""
    g = np.random.default_rng(seed)
    base = g.uniform(-0.5, 0.2, size=(B, 1, n, 3))
    drift = (np.linspace(0, 0.5, T)[None, :, None, None]
             * np.array([1.0, 0.4, -0.6]))
    pts = (base + drift).astype(np.float32)
    vox = np.stack([np.stack([voxelize_np(pts[b, t], G)
                              for t in range(T)]) for b in range(B)])
    return vox.astype(np.float32), pts


def jax_sample_eps(model, params, key, T, sample_num, B, Z):
    """The noise ``HSVRNNBVH.encode`` draws from the ``"sample"`` key
    ``key``: the first ``make_rng("sample")`` of the dynamics module, split
    T ways, one ``normal((sample_num, B, Z))`` per step (dynamics.py:494,
    :501). (T, sample_num, B, Z) float32."""
    k0 = model.apply(params, method=lambda m: m.dyna_module.make_rng(
        "sample"), rngs={"sample": key})
    keys = jax.random.split(k0, T)
    return np.stack([np.asarray(jax.random.normal(k, (sample_num, B, Z)))
                     for k in keys])
