"""DyNet text-format model files (counterpart of
``rlrpt_tpu/nn/dynet_io.py``; ref: neural_q_pathtracer.cu:55-59, 191-196,
Radiance_Map_Data/cornell_12_12.model).

    #Parameter# /_N {rows,cols} BYTELEN ZERO_GRAD
    <prod(dims) values, each "%+.8e" and one space, then a newline>

BYTELEN is the byte length of the data line including its newline.
Matrices are column-major (Eigen); the order is W1, b1, W2, b2, ...  The
writer gives the JAX package's bytes for the same float32 values, so a
model saved by either package loads in the other.
"""

from __future__ import annotations

import numpy as np

from rlrpt_tpu_torch.nn.dq_network import DQNetwork


def save_dynet_model(net: DQNetwork, path: str) -> None:
    arrays = []
    for layer in net.layers:
        arrays.append(layer.weight.detach().cpu().numpy())
        arrays.append(layer.bias.detach().cpu().numpy())
    with open(path, "w") as f:
        for i, arr in enumerate(arrays):
            dims = "{" + ",".join(str(d) for d in arr.shape) + "}"
            # one % operation over Python floats: the bytes of a per-value
            # f"{v:+.8e} " (the same C formatting), in half the time at the
            # 9 M weights of a 44,820-input net
            vals = arr.flatten(order="F").tolist()
            data = ("%+.8e " * len(vals)) % tuple(vals)
            f.write(f"#Parameter# /_{i} {dims} {len(data) + 1} ZERO_GRAD\n")
            f.write(data + "\n")


def load_dynet_arrays(path: str) -> list[np.ndarray]:
    """Parse a DyNet text model into float32 arrays; raises ValueError on a
    bad header, a value count or a byte length that disagrees with it."""
    arrays: list[np.ndarray] = []
    with open(path) as f:
        while True:
            header = f.readline()
            if not header:
                break
            header = header.strip()
            if not header:
                continue
            parts = header.split()
            if not header.startswith("#") or len(parts) < 4:
                raise ValueError(f"bad dynet header: {header[:60]}")
            dims = tuple(int(d) for d in parts[2].strip("{}").split(","))
            byte_len = int(parts[3])
            line = f.readline()
            # sep=" " splits on whitespace and accepts the trailing space
            vals = np.fromstring(line, dtype=np.float32, sep=" ")
            n_expected = int(np.prod(dims))
            if vals.size != n_expected:
                raise ValueError(f"expected {n_expected} values for dims "
                                 f"{dims}, got {vals.size}")
            n_bytes = len(line) if line.endswith("\n") else len(line) + 1
            if n_bytes != byte_len:
                raise ValueError(f"data line is {n_bytes} bytes, header "
                                 f"says {byte_len}")
            arrays.append(vals.reshape(dims, order="F"))
    return arrays


def load_dynet_model(path: str, device="cuda") -> DQNetwork:
    arrays = load_dynet_arrays(path)
    if len(arrays) % 2 != 0:
        raise ValueError("expected W, b pairs")
    return DQNetwork.from_layers(list(zip(arrays[0::2], arrays[1::2])),
                                 device=device)
