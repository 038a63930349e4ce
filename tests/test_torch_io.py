"""The port's host I/O (utils.bits, models.io, models.keys_io, plonk.layout)
against zerog_tpu's, on the CPU, tolerance zero.

Every input is made from a seed with numpy and goes through both packages:
bit helpers on seeded ints; an HDF5 model and PNG images that the test
writes; circuit-params and proof JSON files; key files over WnnCircuit's
constraint system with seeded points and limb columns (no keygen), written by
either package and read back by the other; the layout PNG of the toy worked
example at k = 12, decoded pixel for pixel.
"""

import numpy as np
import pytest
import torch

from zerog_tpu.curve.bn254 import G1_GEN as J_G1_GEN, g1_mul as j_g1_mul
from zerog_tpu.gadgets.wnn_circuit import WnnCircuitParams as JParams
from zerog_tpu.models import io as jio
from zerog_tpu.models import keys_io as jkeys
from zerog_tpu.plonk.keygen import ProvingKey as JProvingKey
from zerog_tpu.plonk.keygen import VerifyingKey as JVerifyingKey
from zerog_tpu import utils as jbits

from zerog_tpu_torch import convert
from zerog_tpu_torch import utils as bits
from zerog_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from zerog_tpu_torch.field import FR
from zerog_tpu_torch.gadgets.wnn_circuit import WnnCircuitParams
from zerog_tpu_torch.models import io
from zerog_tpu_torch.models import keys_io
from zerog_tpu_torch.plonk import Assignment, ConstraintSystem
from zerog_tpu_torch.plonk.keygen import ProvingKey, VerifyingKey
from zerog_tpu_torch.plonk.selectors import compress_selectors_pass

from test_torch_wnn import TOY, _fields, _toy_jax

torch.set_num_threads(1)


# ---- utils.bits -----------------------------------------------------------------

def test_bits_equal():
    rng = np.random.default_rng(11)
    for _ in range(50):
        n = int(rng.integers(1, 80))
        x = int.from_bytes(rng.bytes(12), "little")
        be = bits.to_be_bits(x, n)
        assert be == jbits.to_be_bits(x, n)
        assert bits.from_be_bits(be) == jbits.from_be_bits(be) == x % (1 << n)
        w, b = int(rng.integers(1, 9)), int(rng.integers(1, 11))
        assert bits.decompose_word_be(x, w, b) == jbits.decompose_word_be(x, w, b)
        vals = rng.integers(0, 50, int(rng.integers(1, 12))).tolist()
        assert bits.argmax(vals) == jbits.argmax(vals)
        d = int(rng.integers(1, 1000))
        assert bits.integer_division(x, d) == jbits.integer_division(x, d) == x // d
    assert bits.argmax([0, 0]) == jbits.argmax([0, 0]) == 0


# ---- models.io: HDF5 models, PNG images, JSON files ----------------------------

def _write_hdf5(path, seed):
    """A Tiny-shaped model file whose thresholds quantize to 0, 255 and 256
    (beside seeded values in between)."""
    import h5py

    c, e, fi, bpi, width = 10, 256, 28, 1, 28
    n_inputs = width * width
    rng = np.random.default_rng(seed)
    thr = rng.random((width, width, bpi))
    thr.flat[:6] = [0.0, -0.25, 1.0, 254.2 / 255, 1.5, 2.0]
    with h5py.File(path, "w") as f:
        f.attrs.update(num_classes=c, num_inputs=n_inputs, bits_per_input=bpi,
                       num_filter_inputs=fi, num_filter_entries=e,
                       num_filter_hashes=1, p=509)
        f["bloom_filters"] = rng.random((c, n_inputs * bpi // fi, e)) < 0.3
        f["binarization_thresholds"] = thr.astype(np.float32)
        f["input_order"] = rng.permutation(n_inputs * bpi)


def _write_png(path, image):
    from PIL import Image

    rgb = np.stack([image, image // 2, 255 - image], axis=-1).astype(np.uint8)
    Image.fromarray(rgb, "RGB").save(path)


def test_load_wnn_equal(tmp_path):
    path = tmp_path / "model.hdf5"
    _write_hdf5(path, seed=3)
    w, jw = io.load_wnn(path), jio.load_wnn(path)
    for a, b in zip(_fields(w), _fields(jw)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b
    thr = w.binarization_thresholds
    assert thr.flat[:6].tolist() == [0, 0, 255, 255, 256, 256]
    assert thr.dtype == np.uint16 and thr.max() == 256


def test_load_grayscale_image_equal(tmp_path):
    image = np.random.default_rng(5).integers(0, 256, (28, 28)).astype(np.uint8)
    _write_png(tmp_path / "img.png", image)
    got = io.load_grayscale_image(tmp_path / "img.png")
    assert got.dtype == np.uint8 and np.array_equal(got, image)
    assert np.array_equal(got, jio.load_grayscale_image(tmp_path / "img.png"))


@pytest.mark.parametrize("name,label", [
    ("0000_7.png", 7), ("dir/0042_0.png", 0), ("x9.png", 9),
    ("0000_7.jpg", None), ("0000_7", None), ("0000_7.png.bak", None)])
def test_parse_png_file(name, label):
    assert io.parse_png_file(name) == jio.parse_png_file(name) == label


def test_json_files_byte_equal(tmp_path):
    rng = np.random.default_rng(7)
    d = dict(p=509, l=8, n_hashes=1, bits_per_hash=8, bits_per_filter=28,
             n_classes=10)
    io.write_circuit_params(WnnCircuitParams(**d), tmp_path / "cp_t.json")
    jio.write_circuit_params(JParams(**d), tmp_path / "cp_j.json")
    assert (tmp_path / "cp_t.json").read_bytes() == (tmp_path / "cp_j.json").read_bytes()
    assert io.read_circuit_params(tmp_path / "cp_j.json") == WnnCircuitParams(**d)
    assert jio.read_circuit_params(tmp_path / "cp_t.json") == JParams(**d)

    proof = rng.bytes(1472)
    outputs = [int(v) for v in rng.integers(0, 29, 10)]
    io.write_proof_with_output(proof, np.asarray(outputs), tmp_path / "p_t.json")
    jio.write_proof_with_output(proof, outputs, tmp_path / "p_j.json")
    assert (tmp_path / "p_t.json").read_bytes() == (tmp_path / "p_j.json").read_bytes()
    assert io.read_proof_with_output(tmp_path / "p_j.json") == (proof, outputs)
    assert jio.read_proof_with_output(tmp_path / "p_t.json") == (proof, outputs)


# ---- models.keys_io: key files both ways ----------------------------------------

TOY_PARAMS = dict(p=2097143, l=20, n_hashes=2, bits_per_hash=10,
                  bits_per_filter=12, n_classes=2)
KEY_K = 8


def _toy_layout():
    """The selector-compression layout of the toy circuit's keygen."""
    w = convert.wnn_from_reference(*_fields(_toy_jax()))
    cs = ConstraintSystem()
    circuit = w.get_circuit(np.zeros_like(TOY["image"]))
    cfg = circuit.configure(cs)
    asn = Assignment(cs, 1 << 12)
    circuit.synthesize(cfg, asn)
    asn.finalize_tables()
    compress_selectors_pass(cs, asn)
    return cs.compression


def _seeded_key(pkg, layout, seed):
    """A key over WnnCircuit's CS (compressed by `layout` or not) with seeded
    commitments and fixed / sigma columns, made by package `pkg`."""
    if pkg == "port":
        from zerog_tpu_torch.gadgets.wnn_circuit import WnnCircuit
        from zerog_tpu_torch.plonk.selectors import (SelectorCompression,
                                                     apply_layout_to_cs)
        cs_cls, params, vk_cls, pk_cls = (ConstraintSystem, WnnCircuitParams,
                                          VerifyingKey, ProvingKey)
        mul, gen = g1_mul, G1_GEN
    else:
        from zerog_tpu.gadgets.wnn_circuit import WnnCircuit
        from zerog_tpu.plonk.cs import ConstraintSystem as cs_cls
        from zerog_tpu.plonk.selectors import (SelectorCompression,
                                               apply_layout_to_cs)
        params, vk_cls, pk_cls = JParams, JVerifyingKey, JProvingKey
        mul, gen = j_g1_mul, J_G1_GEN
    cs = cs_cls()
    WnnCircuit.configure_with_params(cs, params(**TOY_PARAMS))
    if layout is not None:
        apply_layout_to_cs(cs, SelectorCompression(layout.keep, layout.combos))
    rng = np.random.default_rng(seed)
    n = 1 << KEY_K

    def scalar():
        return int.from_bytes(rng.bytes(32), "little") % FR.p

    def column():
        return np.asarray([scalar() for _ in range(n)], dtype=object)

    n_perm = len(cs.permutation_columns)
    fixed_coms = [mul(gen, scalar()) for _ in range(cs.num_fixed)]
    perm_coms = [mul(gen, scalar()) for _ in range(n_perm)]
    vk = vk_cls(KEY_K, cs, fixed_coms, perm_coms)
    return pk_cls(vk, [column() for _ in range(cs.num_fixed)],
                  [column() for _ in range(n_perm)])


def _compression(cs):
    c = cs.compression
    return None if c is None else (tuple(c.keep), tuple(c.combos))


@pytest.fixture(scope="module")
def toy_layout():
    return _toy_layout()


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_key_files_read_back_in_the_other_package(tmp_path, toy_layout, writer,
                                                   compressed):
    layout = toy_layout if compressed else None
    assert layout is None or layout.combos
    pk = _seeded_key(writer, layout, seed=13)
    pk_path, vk_path = tmp_path / "pk.npz", tmp_path / "vk.npz"
    (keys_io if writer == "port" else jkeys).write_keys(pk, pk_path, vk_path)
    params = (JParams if writer == "port" else WnnCircuitParams)(**TOY_PARAMS)
    reader = jkeys if writer == "port" else keys_io
    got_pk = reader.read_pk(pk_path, params)
    got_vk = reader.read_vk(vk_path, params)
    other = _seeded_key("jax" if writer == "port" else "port", layout, seed=13)
    for vk in (got_pk.vk, got_vk):
        assert vk.k == pk.vk.k == KEY_K
        assert vk.fixed_commitments == pk.vk.fixed_commitments
        assert vk.permutation_commitments == pk.vk.permutation_commitments
        assert _compression(vk.cs) == _compression(pk.vk.cs)
        assert vk.transcript_repr == pk.vk.transcript_repr == other.vk.transcript_repr
    for got, want in ((got_pk.fixed_values, pk.fixed_values),
                      (got_pk.sigma_values, pk.sigma_values)):
        assert len(got) == len(want) > 0
        assert all(list(a) == list(b) for a, b in zip(got, want))
    # the port's reader gives host object columns, as its keygen does
    if writer == "jax":
        assert got_pk.fixed_values[0].dtype == object and not got_pk._cache


def test_key_files_byte_layout_equal(tmp_path, toy_layout):
    """Both writers put the same arrays, names and dtypes in the npz."""
    for pkg, mod in (("port", keys_io), ("jax", jkeys)):
        mod.write_keys(_seeded_key(pkg, toy_layout, seed=17),
                       tmp_path / f"pk_{pkg}.npz", tmp_path / f"vk_{pkg}.npz")
    for kind in ("pk", "vk"):
        a = np.load(tmp_path / f"{kind}_port.npz")
        b = np.load(tmp_path / f"{kind}_jax.npz")
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype
            assert np.array_equal(a[name], b[name]), name


# ---- plonk.layout / Wnn.plot_circuit ---------------------------------------------

def test_layout_png_pixels_equal(tmp_path):
    from PIL import Image

    jw = _toy_jax()
    w = convert.wnn_from_reference(*_fields(jw))
    assert w.plot_circuit(str(tmp_path / "t.png"), 12) == str(tmp_path / "t.png")
    jw.plot_circuit(str(tmp_path / "j.png"), 12)
    got = np.asarray(Image.open(tmp_path / "t.png").convert("RGBA"))
    want = np.asarray(Image.open(tmp_path / "j.png").convert("RGBA"))
    assert got.shape == want.shape and got.shape[0] > 100
    assert np.array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 3   # not a blank canvas

