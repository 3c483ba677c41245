"""Entry points of the PyTorch + CUDA port, the counterparts of
__graft_entry__.py's: `entry`, a one-step check of the fused HCA decode on
the card, and `dryrun_multichip`, every sharded entry point over a mesh,
byte-strict against the unsharded calls.

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
    up = hca_unpack_device.DeviceUnpacker(info, device=device)

    def fn(frames):
        return pipeline.decode_rows(up, frames, info)

    return fn, (frames,)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run every sharded entry point over an n-device mesh, byte-strict:
    the counterpart of __graft_entry__.py's dryrun_multichip, with its
    tiny streams, shapes and checks. The mesh is (n / 2, 2) (streams over
    dp, frames over sp) for an even n > 2, else (n, 1). It takes the first
    n visible CUDA cards where there are that many, else `devices` (n of
    them; one may repeat, e.g. ["cuda:0"] * 4 or ["cpu"] * 8), and raises
    where it has neither.

    Where the JAX dry run holds a result to a JAX function the port cannot
    import (the native HCA decode and encode, the AHX host lane, the ADX
    models), this holds it to the port's unsharded call on the mesh's
    first device, which the CPU tests hold to those JAX functions."""
    import torch

    from pycricodecs_tpu_torch import parallel
    from pycricodecs_tpu_torch.utils.wav import write_wav

    n = int(n_devices)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible >= n:
        devices = [torch.device("cuda", i) for i in range(n)]
    elif devices is None:
        raise RuntimeError(f"dryrun_multichip: {n} devices wanted, {visible} "
                           f"CUDA cards visible and no devices given")
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"dryrun_multichip: {n} devices wanted, "
                         f"{len(devices)} given")
    shape = (n // 2, 2) if n % 2 == 0 and n > 2 else (n, 1)
    mesh = parallel.make_mesh(shape, devices=devices[:n])
    one = devices[0]

    # tiny real streams end-to-end: encode -> batched sharded decode
    pcm = (np.sin(np.arange(8192) / 10.0) * 8000).astype(np.int16)
    stereo = np.stack([pcm, pcm], 1).reshape(-1)
    wav = write_wav(stereo, 2, 48000)
    hca_blob = parallel.hca_encode_batch([wav], quality=2, device=one)[0]
    blobs = [hca_blob] * (2 * n + 1)      # odd count exercises padding
    stats = parallel.DecodeStats()
    decoded = parallel.decode_batch(blobs, mesh=mesh, stats=stats)
    assert stats.device_unpack_streams == len(blobs), \
        "sharded decode did not decode every stream on the device"
    assert len(decoded) == len(blobs)
    assert all(isinstance(b, bytes) and len(b) > 44 for b in decoded)
    single = parallel.decode_batch([hca_blob], device=one)[0]
    assert set(decoded) == {single}, "sharded decode is not bit-exact"

    # AHX (MPEG-2 Layer II): stream axis sharded over the same mesh
    from pycricodecs_tpu_torch.models.ahx import AHX
    mono = write_wav(pcm[:22050], 1, 22050)
    ahx_blob = AHX.encode(mono, bitrate_kbps=96, device=one)
    ahx_blobs = [ahx_blob] * (n + 1)
    ahx_wavs = parallel.ahx_decode_batch(ahx_blobs, mesh=mesh)
    ref = parallel.ahx_decode_batch([ahx_blob], device=one)[0]
    assert len(ahx_wavs) == len(ahx_blobs)
    assert set(ahx_wavs) == {ref}, "sharded AHX decode is not bit-exact"

    # HCA encode sharded over the same mesh: the unsharded encode's bytes
    enc_wavs = [wav] * (n + 1)
    enc = parallel.hca_encode_batch(enc_wavs, quality=2, mesh=mesh)
    assert set(enc) == {hca_blob}, "sharded HCA encode is not bit-exact"

    # AHX encode sharded over the same mesh
    ahx_enc_wavs = [mono] * (n + 1)
    ahx_enc = parallel.ahx_encode_batch(ahx_enc_wavs, bitrate_kbps=96,
                                        mesh=mesh)
    ahx_ref = parallel.ahx_encode_batch(ahx_enc_wavs[:1], bitrate_kbps=96,
                                        device=one)
    assert set(ahx_enc) == {ahx_ref[0]}, \
        "sharded AHX encode diverged from unsharded"

    # ADX: lanes (streams x channels) over every device of the mesh
    quiet = stereo.copy()
    quiet[:128] = 0
    adx_wav = write_wav(quiet, 2, 48000)
    adx_blob = parallel.adx_encode_batch([adx_wav], device=one)[0]
    adx_blobs = [adx_blob] * (n + 1)
    adx_dec = parallel.adx_decode_batch(adx_blobs, mesh=mesh)
    assert set(adx_dec) == {parallel.adx_decode_batch([adx_blob],
                                                      device=one)[0]}, \
        "sharded ADX decode is not bit-exact"
    adx_enc = parallel.adx_encode_batch([adx_wav] * (n + 1), mesh=mesh)
    assert set(adx_enc) == {adx_blob}, "sharded ADX encode is not bit-exact"
    print(f"dryrun_multichip OK: mesh={shape} on "
          f"{sorted({str(d) for d in devices[:n]})}, {len(blobs)} HCA + "
          f"{len(ahx_blobs)} AHX + {len(adx_blobs)} ADX streams decoded, "
          f"{len(enc_wavs)} HCA + {len(ahx_enc_wavs)} AHX + "
          f"{len(adx_blobs)} ADX streams encoded")


if __name__ == "__main__":
    fn, args = entry()
    pcm, err = fn(*args)
    print("entry OK:", tuple(pcm.shape), pcm.dtype, "err:", bool(err.any()))
