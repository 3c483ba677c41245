"""Command line of the PyTorch + CUDA port (the JAX package's CLI, on a GPU).

    python -m pycricodecs_tpu_torch decode music.hca -o music.wav --key 0x...
    python -m pycricodecs_tpu_torch encode music.wav -o music.hca --format hca
    python -m pycricodecs_tpu_torch extract bank.acb -o outdir --decode
    python -m pycricodecs_tpu_torch extract archive.cpk -o outdir
    python -m pycricodecs_tpu_torch extract movie.usm -o outdir --decode
    python -m pycricodecs_tpu_torch bank-decode bank.acb -o outdir
    python -m pycricodecs_tpu_torch find-key enc.hca --range 0x1000 65536
    python -m pycricodecs_tpu_torch info file.adx
    python -m pycricodecs_tpu_torch build tracks/ -o bank.acb
    python -m pycricodecs_tpu_torch build gamedata/ -o data.cpk --compress
    python -m pycricodecs_tpu_torch build movie.ivf -o movie.usm \
        --audio voice.wav --codec hca --key 0x1234 --encrypt

Every command takes --device (default cuda); work runs there and nowhere
else (`build` uses it for a USM's audio encoders and a CPK's CRILAYLA
compress; a `build` of an AWB or ACB runs on the host alone). An ACB is
opened by
its path, so a sibling `<Name>.awb` resolves beside it from any working
directory (the JAX package's CLI opens it from bytes, which resolves the
sibling against the working directory); the files written are the same.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _int0(x: str) -> int:
    return int(x, 0)


def _sniff(data: bytes) -> str:
    from .utils.sniff import sniff
    try:
        return sniff(data)
    except ValueError as exc:
        raise SystemExit(str(exc))


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


def cmd_decode(args) -> None:
    from .models import adx, hca
    from .models.ahx import AHX

    data = _read(args.input)
    kind = _sniff(data)
    if kind == "adx":
        wav = adx.decode(data, device=args.device)
    elif kind == "hca":
        wav = hca.decode(data, key=args.key, subkey=args.subkey,
                         device=args.device)
    elif kind == "ahx":
        wav = AHX.decode(data, device=args.device)
    else:
        raise SystemExit(f"decode expects ADX/AHX/HCA input, got {kind}")
    out = args.output or os.path.splitext(args.input)[0] + ".wav"
    _write(out, wav)
    print(out)


def cmd_encode(args) -> None:
    from .models import adx, hca
    from .parallel import pipeline

    data = _read(args.input)
    if _sniff(data) != "wav":
        raise SystemExit("encode expects a WAV input")
    if args.format == "adx":
        blob = adx.encode(data, bit_depth=args.bitdepth,
                          encoding_mode=args.mode, scale_fix=args.scale_fix,
                          device=args.device)
        ext = ".adx"
    elif args.format == "ahx":
        from .models.ahx import AHX
        blob = AHX.encode(data, bitrate_kbps=args.bitrate, device=args.device)
        ext = ".ahx"
    else:
        blob = pipeline.hca_encode_batch([data], quality=args.quality,
                                         device=args.device)[0]
        if args.key:
            hs = int.from_bytes(blob[6:8], "big")
            blob = hca.crypt(blob, True, hs, 56, args.key, args.subkey)
        ext = ".hca"
    out = args.output or os.path.splitext(args.input)[0] + ext
    _write(out, blob)
    print(out)


def cmd_extract(args) -> None:
    from .containers.acb import ACB
    from .containers.awb import AWB
    from .containers.cpk import CPK
    from .containers.usm import USM

    data = _read(args.input)
    kind = _sniff(data)
    out = args.output or os.path.splitext(args.input)[0]
    if kind == "cpk":
        CPK(args.input, device=args.device).extract(dirname=out)
    elif kind == "acb":
        ACB(args.input).extract(decode=args.decode, key=args.key,
                                dirname=out, device=args.device)
    elif kind == "awb":
        AWB(data).extract(decode=args.decode, key=args.key, dirname=out,
                          device=args.device)
    elif kind == "usm":
        usm = USM(args.input, key=args.key if args.key else False,
                  device=args.device)
        usm.extract(dirname=out, decode=args.decode, key=args.key,
                    subkey=args.subkey)
    else:
        raise SystemExit(f"extract expects CPK/ACB/AWB/USM, got {kind}")
    print(out)


def cmd_bank_decode(args) -> None:
    from .parallel import pipeline

    data = _read(args.input)
    kind = _sniff(data)
    out = args.output or os.path.splitext(args.input)[0] + "_wav"
    os.makedirs(out, exist_ok=True)
    if kind == "acb":
        wavs = pipeline.decode_acb(args.input, key=args.key,
                                   device=args.device)
    elif kind == "awb":
        wavs = pipeline.decode_awb(data, key=args.key, device=args.device)
    else:
        raise SystemExit(f"bank-decode expects ACB/AWB, got {kind}")
    for i, wav in enumerate(wavs):
        if isinstance(wav, (bytes, bytearray)):
            _write(os.path.join(out, f"{i}.wav"), wav)
    print(out)


def cmd_build(args) -> None:
    """Build a container from a directory (cpk/awb/acb) or video+audio
    (usm): the JAX package's build."""
    ext = os.path.splitext(args.output)[1].lower().lstrip(".")
    if ext == "cpk":
        from .containers.cpk import CPKBuilder
        CPKBuilder(args.input, args.output, CpkMode=args.cpk_mode,
                   encrypt=args.encrypt, compress=args.compress,
                   device=args.device)
    elif ext == "awb":
        from .containers.awb import AWBBuilder
        AWBBuilder(args.input, subkey=args.subkey).build(args.output)
    elif ext == "acb":
        from .containers.acb import ACBBuilder
        names, tracks = [], []
        for fn in sorted(os.listdir(args.input)):
            path = os.path.join(args.input, fn)
            if os.path.isfile(path):
                names.append(os.path.splitext(fn)[0])
                tracks.append(_read(path))
        if not tracks:
            raise SystemExit(f"no files in {args.input}")
        blob = ACBBuilder(tracks, name=os.path.splitext(
            os.path.basename(args.output))[0], cue_names=names).build()
        _write(args.output, blob)
    elif ext == "usm":
        from .containers.usm import USMBuilder
        if not args.audio:
            builder = USMBuilder(args.input, key=args.key or False,
                                 device=args.device)
        else:
            builder = USMBuilder(args.input, args.audio,
                                 key=args.key or False,
                                 audio_codec=args.codec,
                                 encryptAudio=bool(args.key and args.encrypt),
                                 device=args.device)
        _write(args.output, builder.build())
    else:
        raise SystemExit("build output must end in .cpk/.awb/.acb/.usm")
    print(args.output)


def cmd_find_key(args) -> None:
    import numpy as np

    from .parallel import pipeline

    data = _read(args.input)
    if args.candidates:
        with open(args.candidates) as fh:
            cands = [int(line.strip(), 0) for line in fh
                     if line.strip() and not line.startswith("#")]
        cands = np.asarray(cands, dtype=np.uint64)
    elif args.range:
        start, count = args.range
        cands = np.uint64(start) + np.arange(count, dtype=np.uint64)
    else:
        raise SystemExit("pass --candidates FILE or --range START COUNT")
    scores = pipeline.find_key(data, cands, subkey=args.subkey,
                               max_frames=args.max_frames,
                               device=args.device)
    order = pipeline.rank_keys(scores)[:args.top]
    for i in order:
        if scores[i] < 0:
            break
        print(f"0x{int(cands[i]):016X}  score={int(scores[i])}")
    if scores.max() < 0:
        print("no plausible key found", file=sys.stderr)
        raise SystemExit(1)


def cmd_info(args) -> None:
    data = _read(args.input)
    kind = _sniff(data)
    if kind == "hca":
        from .models.hca import HCA
        print(json.dumps(HCA(data, key=args.key, device=args.device).info(),
                         default=str, indent=2))
    elif kind == "adx":
        from .models.adx import parse_adx_header
        h = parse_adx_header(data, strict_cri_check=False)
        print(json.dumps({k: getattr(h, k) for k in (
            "version", "encoding_mode", "block_size", "bit_depth", "channels",
            "sample_rate", "sample_count", "looping")}, default=str, indent=2))
    elif kind == "ahx":
        from .models.ahx import AHX
        print(json.dumps(AHX.info(data), default=str, indent=2))
    elif kind == "ivf":
        from .containers.ivf import IVF
        print(json.dumps(IVF(data).info(), default=str, indent=2))
    elif kind == "usm":
        from .containers.usm import USM
        u = USM(args.input, key=args.key if args.key else False,
                device=args.device)
        u.demux()
        print(json.dumps([{k: str(v) for k, v in t.items()}
                          for t in u.get_metadata()[:1]], indent=2))
    else:
        print(json.dumps({"format": kind, "size": len(data)}, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="pycricodecs_tpu_torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, key=True):
        p.add_argument("input")
        p.add_argument("-o", "--output", default=None)
        p.add_argument("--device", default="cuda",
                       help="torch device the work runs on (default cuda)")
        if key:
            p.add_argument("--key", type=_int0, default=0)
            p.add_argument("--subkey", type=_int0, default=0)

    p = sub.add_parser("decode", help="ADX/AHX/HCA -> WAV")
    common(p)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("encode", help="WAV -> ADX/AHX/HCA")
    p.add_argument("--scale-fix", action="store_true", dest="scale_fix",
                   help="ADX: decoder-exact quantiser (fixes the "
                        "reference's high-bitdepth popping; output stays "
                        "standard ADX)")
    common(p)
    p.add_argument("--format", choices=("adx", "ahx", "hca"), default="hca")
    p.add_argument("--bitrate", type=int, default=None,
                   help="AHX/MP2 bitrate in kbps")
    p.add_argument("--quality", type=int, default=1,
                   help="HCA quality 0 (highest) .. 4")
    p.add_argument("--bitdepth", type=int, default=4)
    p.add_argument("--mode", type=int, default=3, choices=(2, 3, 4))
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("extract", help="CPK/ACB/AWB/USM -> files")
    common(p)
    p.add_argument("--decode", action="store_true",
                   help="decode audio members to WAV while extracting")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("bank-decode", help="ACB/AWB -> WAVs (one GPU batch)")
    common(p)
    p.set_defaults(fn=cmd_bank_decode)

    p = sub.add_parser("build", help="dir -> CPK/AWB/ACB, or IVF(+WAV) -> USM")
    p.add_argument("input", help="directory (cpk/awb/acb) or IVF video (usm)")
    p.add_argument("-o", "--output", required=True,
                   help="output file; extension picks the container")
    p.add_argument("--audio", help="audio track for USM (WAV/ADX/HCA)")
    p.add_argument("--codec", default="adx", choices=["adx", "hca"],
                   help="USM audio codec")
    p.add_argument("--cpk-mode", type=int, default=1, choices=[0, 1, 2, 3])
    p.add_argument("--compress", action="store_true",
                   help="CRILAYLA-compress CPK members")
    p.add_argument("--encrypt", action="store_true",
                   help="encrypt CPK tables / USM streams")
    p.add_argument("--key", type=_int0, default=0)
    p.add_argument("--subkey", type=_int0, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of a USM's audio encoders and a CPK's "
                        "compress (default cuda)")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("find-key", help="batched keycode search")
    common(p, key=False)
    p.add_argument("--subkey", type=_int0, default=0)
    p.add_argument("--candidates", default=None,
                   help="file with one keycode per line")
    p.add_argument("--range", nargs=2, type=_int0, default=None,
                   metavar=("START", "COUNT"))
    p.add_argument("--max-frames", type=int, default=16)
    p.add_argument("--top", type=int, default=5)
    p.set_defaults(fn=cmd_find_key)

    p = sub.add_parser("info", help="print header/metadata")
    common(p)
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
