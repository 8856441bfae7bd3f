"""Weights for the LM tests of the port: the reference's parameter pytree
filled with seeded numpy draws, handed to both packages."""
import jax
import numpy as np

from repro.models import model as jmodel


def numpy_params(jcfg, seed):
    """Matrices N(0, 1/fan_in) (the embedding N(0, 1)) and the
    zero-initialized norm scales N(0, 0.01), so that ``1 + scale`` is
    exercised; ``units`` leaves are stacked on dim 0, as the reference
    stacks them."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        shp = s.shape[1:] if names[0] == "units" else s.shape
        if len(shp) == 1:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        scale = 1.0 if names[-1] == "embedding" else shp[0] ** -0.5
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
