"""``configs/shapes.py`` against the JAX package's: for every architecture
x assigned input shape, with the config's cache dtype and with an fp8 one,
the variant (the windowed long-context variants, whisper's skip) and every
input spec's shape and dtype. The port's specs are ``meta`` tensors, JAX's
``ShapeDtypeStruct``s; the port's decode position is an int."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402


def _leaves(specs):
    """{name: (shape, dtype name)} of a spec dict or a (token, caches)
    pair, absent stacks left out."""
    if isinstance(specs, dict):
        items = specs.items()
    else:
        token, caches = specs
        items = [("token", token)] + [
            (k, v) for k, v in caches._asdict().items() if k != "pos"]
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in items if v is not None}


def test_shapes_and_window_match_jax():
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW
    assert {k: dataclasses.astuple(v) for k, v in
            shapes.INPUT_SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jshapes.INPUT_SHAPES.items()}


@pytest.mark.parametrize("kv_dtype", ["", "float8_e4m3fn"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_match_jax(arch, kv_dtype):
    for name, shape in shapes.INPUT_SHAPES.items():
        jshape = jshapes.INPUT_SHAPES[name]
        jcfg = jshapes.variant_for_shape(jconfigs.get_config(arch), jshape)
        cfg = shapes.variant_for_shape(configs.get_config(arch), shape)
        assert (cfg is None) == (jcfg is None), (arch, name)
        if cfg is None:
            assert arch == "whisper-medium" and name == "long_500k"
            continue
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        if kv_dtype:
            jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
            cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        want = jshapes.input_specs(jcfg, jshape)
        got = shapes.input_specs(cfg, shape)
        assert _leaves(got) == _leaves(want), (arch, name)
        if shape.kind == "decode":
            assert got[1].pos == shape.seq_len - 1
            assert all(t.device.type == "meta" for t in
                       _as_list(got[1]) + [got[0]])


def _as_list(caches):
    return [v for k, v in caches._asdict().items()
            if k != "pos" and v is not None]
