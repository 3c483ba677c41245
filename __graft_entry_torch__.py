"""Entry point of the PyTorch + CUDA port: a one-step check of its fused
HCA decode on the card (the port's counterpart of __graft_entry__.py's
`entry`; the sharded dry run has no counterpart yet).

    python3 __graft_entry_torch__.py            # on a CUDA GPU
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

#: copies of the example stream in the batch
STREAMS = 4


def entry(device="cuda"):
    """(fn, example_args) for one step of the port's flagship path, the
    device half of the batched HCA decode: fn(frames) deciphers and unpacks
    the raw frame bytes (kernels B1, B2) and runs the transform to PCM16
    (kernel B3), returning (pcm i16 [B, F * 1024, C], err bool [B, F]) on
    `device`, the JAX entry's (pcm, err) with pcm viewed as samples x
    channels.

    The example is the JAX entry's stream: 16 x 1024 samples of
    sin(n / 9) * 8000 on both channels at 48 kHz, encoded at quality 2 (by
    the port's hca_encode_batch on `device`, equal to the JAX package's
    host encoder), its frames stacked B = 4 times: example_args is
    (frames u8 [B, F, frame_size] on `device`,)."""
    import torch

    from pycricodecs_tpu_torch.ops import hca_frame, hca_unpack_device
    from pycricodecs_tpu_torch.parallel import pipeline
    from pycricodecs_tpu_torch.utils.wav import write_wav

    device = torch.device(device)
    # a small real stream: the unpacker's step sequence is config-derived,
    # so synthetic tensors cannot stand in for actual frame bytes
    pcm = (np.sin(np.arange(16 * 1024) / 9.0) * 8000).astype(np.int16)
    stereo = np.stack([pcm, pcm], 1).reshape(-1)
    blob = pipeline.hca_encode_batch([write_wav(stereo, 2, 48000)],
                                     quality=2, device=device)[0]
    hs = int.from_bytes(blob[6:8], "big")
    info = hca_frame.parse_header(blob[:hs])
    fs, F = info.frame_size, info.frame_count
    arr = np.frombuffer(blob[hs:hs + F * fs], np.uint8).reshape(F, fs)
    frames = torch.from_numpy(
        np.broadcast_to(arr, (STREAMS, F, fs)).copy()).to(device)
    up = hca_unpack_device.DeviceUnpacker(info, device)

    def fn(frames):
        return pipeline.decode_rows(up, frames, info)

    return fn, (frames,)


if __name__ == "__main__":
    fn, args = entry()
    pcm, err = fn(*args)
    print("entry OK:", tuple(pcm.shape), pcm.dtype, "err:", bool(err.any()))
