"""JAX's default PRNG, pinned for the port's tests (a helper module, not
collected as tests).

Every JAX experiment runs wav2vec2forbrain_tpu/util/tpu_setup.py::
configure_jax, which switches jax_default_prng_impl to "rbg" for the rest
of the process. In one xdist worker a JAX experiment built by an earlier
test file so changes the keys a later file draws, and a test's result
would depend on the order the files run in. `pinned_prng()` pins JAX's
own default, threefry2x32 (or the implementation named), around a block
and then restores the value it found. `jax_threefry` pins threefry2x32
around a whole module, its module fixtures included: a test file imports
it (`from torch_jax_prng import jax_threefry`), and pytest then uses it
there. `jax_rbg` pins "rbg" instead, for a file whose JAX side builds JAX
experiments: they run under "rbg" (configure_jax's), whether or not an
earlier file already switched it. Without jax (the card's machine runs
the `cuda` tests of some of these files) nothing is pinned.
"""

import contextlib

import pytest

IMPL = "threefry2x32"


@contextlib.contextmanager
def pinned_prng(impl: str = IMPL):
    try:
        import jax
    except ImportError:
        yield
        return
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", impl)
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", prev)


@pytest.fixture(scope="module", autouse=True)
def jax_threefry():
    with pinned_prng():
        yield


@pytest.fixture(scope="module", autouse=True)
def jax_rbg():
    with pinned_prng("rbg"):
        yield
