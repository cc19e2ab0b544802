"""The port's safetensors readers against the JAX package's and the
``safetensors`` package: the native reader (``io/native_st.py``, the C++
header parser built with g++ into ``build/native/``) and the Python one
(``utils/st_file.py``); the retained-view guard through torch views; the
fallback when the build fails; the streaming writer. Tiny tensors, numpy
seeds, CPU."""

import os

import numpy as np
import pytest
import torch

from llama32mm_tpu.io import native_st as jax_native_st
from llama32mm_tpu_torch.io import native_st
from llama32mm_tpu_torch.utils import st_file


@pytest.fixture()
def shard(tmp_path):
    import ml_dtypes
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    tensors = {
        "a.weight": rng.normal(size=(17, 33)).astype(np.float32),
        "b.bias": rng.normal(size=(64,)).astype(np.float32),
        "c.emb": rng.integers(-5, 5, (4, 8, 2)).astype(np.int32),
        "d.half": rng.normal(size=(5, 5)).astype(np.float16),
        "e.bf16": rng.normal(size=(3, 7)).astype(ml_dtypes.bfloat16),
        "f.bytes": rng.integers(0, 255, (9,)).astype(np.uint8),
    }
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    return path, tensors


def _as_torch(arr):
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def test_native_build_is_named_by_the_source_hash():
    assert native_st.ensure_built()
    lib = native_st.library_path()
    assert lib.exists() and lib.parent == native_st.BUILD_DIR
    assert lib.name.startswith("libstreader_") and native_st.native_available()


@pytest.mark.parametrize("reader", ["native", "python"])
def test_readers_match_jax_and_safetensors(reader, shard):
    """Names in the JAX reader's order, values equal to what was written;
    BF16 and F16 keep their dtypes (the JAX reader widens them to fp32)."""
    path, tensors = shard
    it = native_st.iter_tensors(path) if reader == "native" else st_file.iter_file(path)
    got = list(it)
    want = list(jax_native_st.iter_tensors(path))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, w) in zip(got, want):
        assert torch.equal(t, _as_torch(tensors[name])), name
        np.testing.assert_array_equal(t.float().numpy() if t.is_floating_point() else t.numpy(),
                                      w, err_msg=name)
    assert dict(got)["e.bf16"].dtype == torch.bfloat16
    assert dict(got)["d.half"].dtype == torch.float16


def test_native_get_tensor_missing_key_and_bad_file(shard, tmp_path):
    path, _ = shard
    with native_st.NativeSafetensors(path) as f:
        with pytest.raises(KeyError):
            f.get_tensor("nope")
    junk = tmp_path / "junk.safetensors"
    junk.write_bytes(b"\xff" * 100)
    with pytest.raises((OSError, ValueError)):
        native_st.NativeSafetensors(str(junk))


@pytest.mark.parametrize("derive", ["view", "slice", "bf16_bits"])
def test_close_raises_while_a_torch_view_lives(derive, shard):
    """A tensor from ``get_tensor`` and any torch view of it hold the
    mapping's buffer export: close raises until they are gone."""
    path, _ = shard
    f = native_st.NativeSafetensors(path)
    t, code = f.get_tensor("e.bf16" if derive == "bf16_bits" else "a.weight")
    kept = {"view": lambda: t, "slice": lambda: t[1:, ::2],
            "bf16_bits": lambda: t.view(torch.int16)}[derive]()
    del t
    with pytest.raises(RuntimeError, match="outlived"):
        f.close()
    del kept
    f.close()  # the mapping stayed open; now it closes
    assert f._mm is None


@pytest.mark.parametrize("reader", ["native", "python"])
def test_iter_without_copies_guards_retained_views(reader, shard):
    """``copy=False``: a conforming loop (each tensor consumed, the loop
    variable outliving the loop) passes, since the last tensor is a copy;
    keeping an earlier view raises when the iteration ends; ``copy=True``
    tensors may all be kept."""
    path, tensors = shard

    def it(copy):
        return (native_st.iter_tensors(path, copy=copy) if reader == "native"
                else st_file.iter_file(path, copy=copy))

    total = 0.0
    for name, t in it(False):
        total += float(t.float().sum())
    assert np.isfinite(total) and torch.equal(t, _as_torch(tensors[name]))
    kept = []
    with pytest.raises(RuntimeError, match="outlived"):
        for _, t in it(False):
            kept.append(t)
    kept.clear()
    kept = [t for _, t in it(True)]
    assert len(kept) == len(tensors)


def test_failed_build_falls_back_to_the_python_reader(shard, tmp_path, monkeypatch):
    """No compiler: ``native_available()`` is false, ``iter_tensors`` reads
    through ``utils/st_file.py`` (same tensors), and a load says so in its
    report's notes."""
    import jax

    from llama32mm_tpu import init_vlm_params
    from llama32mm_tpu.configs import tiny_mllama_config as jax_tiny_config
    from llama32mm_tpu.io.checkpoint import save_checkpoint_params
    from llama32mm_tpu_torch.configs import tiny_mllama_config
    from llama32mm_tpu_torch.io.checkpoint import load_checkpoint_params

    path, tensors = shard
    want = dict(native_st.iter_tensors(path))
    ckpt = tmp_path / "ckpt"
    jcfg = jax_tiny_config()
    save_checkpoint_params(str(ckpt), init_vlm_params(jax.random.PRNGKey(0), jcfg), jcfg)
    native_model, native_report = load_checkpoint_params(str(ckpt), tiny_mllama_config(), "cpu",
                                                         verbose=False, return_report=True)
    monkeypatch.setattr(native_st, "GXX", "no-such-compiler-g++")
    monkeypatch.setattr(native_st, "BUILD_DIR", tmp_path / "build")
    native_st._load_lib.cache_clear()
    try:
        assert not native_st.ensure_built() and not native_st.native_available()
        got = dict(native_st.iter_tensors(path))
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        model, report = load_checkpoint_params(str(ckpt), tiny_mllama_config(), "cpu",
                                               verbose=False, return_report=True)
    finally:
        monkeypatch.undo()
        native_st._load_lib.cache_clear()
    assert native_report.notes == []
    assert report.notes == ["read through utils/st_file.py: the native reader "
                            "(native/safetensors_reader.cpp) did not build"]
    a, b = model.state_dict(), native_model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert native_st.native_available()


def test_write_file_streams_and_checks_each_tensor(tmp_path):
    """The header comes from the announced shapes; each tensor is produced
    once, in order, and must match its announcement; the file reads back
    with the ``safetensors`` package."""
    from safetensors.torch import load_file

    order = []
    rs = np.random.RandomState(1)
    tensors = {"x": torch.from_numpy(rs.randn(3, 4).astype(np.float32)).bfloat16(),
               "y": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "z": torch.from_numpy(rs.randn(5).astype(np.float32))}

    def produce(name):
        order.append(name)
        return tensors[name]

    entries = [(n, t.dtype, tuple(t.shape), lambda n=n: produce(n)) for n, t in tensors.items()]
    nbytes = st_file.write_file(str(tmp_path / "a.safetensors"), entries)
    assert order == ["x", "y", "z"] and nbytes == 3 * 4 * 2 + 6 * 8 + 5 * 4
    back = load_file(str(tmp_path / "a.safetensors"))
    assert all(torch.equal(back[n], t) for n, t in tensors.items())
    assert st_file.load_file(str(tmp_path / "a.safetensors")).keys() == tensors.keys()
    bad = [("x", torch.float32, (3, 4), lambda: tensors["x"])]
    with pytest.raises(ValueError, match="announced"):
        st_file.write_file(str(tmp_path / "b.safetensors"), bad)
    assert os.path.exists(tmp_path / "b.safetensors")
