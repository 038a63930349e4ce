"""Model / image / artifact IO.

Counterpart of ``zerog_tpu/models/io.py`` (reference src/io.rs): HDF5 model
loading with the exact threshold quantization convention (ceil(255*t)
clamped to [0, 256], where 256 means "unreachable"; reference:
src/io.rs:62-73), grayscale PNG loading (first RGB channel; reference:
src/io.rs:24-33), and JSON (de)serialization for circuit params and proofs.
``h5py`` and PIL are imported inside the functions that need them, so
importing this module needs neither.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from .wnn import Wnn

__all__ = [
    "load_wnn", "load_grayscale_image", "parse_png_file",
    "write_circuit_params", "read_circuit_params",
    "write_proof_with_output", "read_proof_with_output",
]


def load_wnn(path) -> Wnn:
    import h5py

    with h5py.File(path, "r") as f:
        num_classes = int(f.attrs["num_classes"])
        num_inputs = int(f.attrs["num_inputs"])
        bits_per_input = int(f.attrs["bits_per_input"])
        num_filter_inputs = int(f.attrs["num_filter_inputs"])
        num_filter_entries = int(f.attrs["num_filter_entries"])
        num_filter_hashes = int(f.attrs["num_filter_hashes"])
        p = int(f.attrs["p"])

        bloom = np.asarray(f["bloom_filters"]).astype(bool)
        expected = (num_classes, num_inputs * bits_per_input // num_filter_inputs, num_filter_entries)
        assert bloom.shape == expected, (bloom.shape, expected)

        width = int(num_inputs ** 0.5)
        thr_f = np.asarray(f["binarization_thresholds"], dtype=np.float64)
        assert thr_f.shape == (width, width, bits_per_input)
        # Quantize: <u8> >= <f32>  <=>  <u8> >= ceil(<f32>); clamp to [0, 256]
        # (256 is unreachable on purpose — reference: src/io.rs:62-73).
        thr = np.clip(np.ceil(thr_f * 255.0), 0.0, 256.0).astype(np.uint16)

        input_order = np.asarray(f["input_order"]).astype(np.int64)
        assert input_order.shape == (num_inputs * bits_per_input,)

    return Wnn(
        num_classes=num_classes,
        num_filter_inputs=num_filter_inputs,
        num_filter_entries=num_filter_entries,
        num_filter_hashes=num_filter_hashes,
        p=p,
        bloom_filters=bloom,
        input_permutation=input_order,
        binarization_thresholds=thr,
    )


def load_grayscale_image(path) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, dtype=np.uint8)  # [H, W, 3]
    return arr[:, :, 0]


def parse_png_file(path) -> int | None:
    """Class label from a filename like ``0000_7.png`` -> 7 (reference: src/io.rs:93-117)."""
    path = pathlib.Path(path)
    if path.suffix != ".png":
        return None
    return int(path.stem[-1])


def write_circuit_params(params, path) -> None:
    with open(path, "w") as f:
        json.dump(params.to_dict(), f)


def read_circuit_params(path):
    from ..gadgets.wnn_circuit import WnnCircuitParams

    with open(path) as f:
        return WnnCircuitParams.from_dict(json.load(f))


def write_proof_with_output(proof: bytes, outputs, path) -> None:
    with open(path, "w") as f:
        json.dump({"proof": list(proof), "output": [int(o) for o in outputs]}, f)


def read_proof_with_output(path):
    with open(path) as f:
        d = json.load(f)
    return bytes(d["proof"]), [int(o) for o in d["output"]]
