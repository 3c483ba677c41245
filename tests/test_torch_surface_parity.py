"""PyTorch port, its public surface against the JAX package's (CPU).

The port's rule: a JAX call, positional or keyword, run on the port gives
the JAX package's bytes or raises TypeError; it never binds a value to a
different parameter. This file walks every public function and method
(and `__init__`) of every JAX module that the port carries (the module
list is computed: each module of `pycricodecs_tpu` whose counterpart
under `pycricodecs_tpu_torch` exists), one case a callable, and holds:
- a callable the port lacks is in NOT_CARRIED, with its reason;
- the port's positional parameters are the JAX ones, by name, in the same
  places (the port may take fewer by position, never others or more);
- every JAX parameter name is accepted by the port, or is in DEPARTURES,
  and then the port has it keyword-only or not at all.
A new mismatch that is in neither table fails here. The calls whose
bytes this depends on are pinned against the JAX package in
tests/test_torch_jax_calls.py.
"""
import importlib
import importlib.util
import inspect
import pkgutil

import pytest

import pycricodecs_tpu as J

P = inspect.Parameter

#: JAX parameter names the port does not carry as the JAX package does
DEPARTURES = {
    "device": "the JAX `device` is a bool choosing one of its engines; the "
              "port's is keyword-only and names the torch device its "
              "kernels run on (a bool there raises TypeError)",
    "mesh": "keyword-only where the port shards (a `parallel.Mesh` of torch "
            "devices); `encode_batch_device` takes the mesh's devices as "
            "`devices=`",
    "engine": "chooses between the JAX device program and its native host "
              "lanes; the port has one engine, the card (ROADMAP Queue A)",
    "pack": "chooses host or device frame packing in the JAX encode; the "
            "port packs on the device (ROADMAP Queue A)",
    "max_workers": "the thread count of the JAX native host lanes, which "
                   "the port does not carry (ROADMAP Queue A)",
}

#: departures the port may also take in the JAX place, because there they
#: mean what they mean in JAX (decode_awb's third parameter is the mesh)
SAME_MEANING = {"mesh"}

_HOST = ("a JAX host lane (numpy or the native core) that the port runs "
         "as a kernel on the card, with a plain PyTorch version")
_ENGINE = ("a JAX device-engine variant or its dispatch (Pallas, XLA "
           "scans and matmuls, jit caches); the port's counterpart is a "
           "hand-written kernel behind other wrappers")
_F32_LANE = ("the JAX AHX encode's f32 device lane; the port holds its f64 "
             "host lane byte for byte")
_ENCODE_HOST = ("the JAX HCA host encoder's analysis; the port runs it on "
                "the device (hca_encode_device), and its hca_encode_host "
                "carries only the configuration, timeline and header")
_PICK = "chooses the JAX engine; the port has one (ROADMAP Queue A)"

#: JAX public callables the port does not carry, by design
NOT_CARRIED = {
    **{f"ops.adx_kernels:{n}": _ENGINE for n in (
        "adx_decode_serial_pallas", "adx_unpack_device",
        "adx_decode_device_pipeline", "adx_encode_serial_pallas",
        "adx_pack_device", "adx_encode_device_pipeline")},
    **{f"ops.adx_kernels:{n}": _HOST for n in (
        "adx_decode_host", "adx_encode_host", "adx_decode_numpy",
        "adx_encode_numpy")},
    "ops.hca_encode_device:hca_frame_pack": _ENGINE,
    **{f"ops.hca_encode_host:{n}": _ENCODE_HOST for n in (
        "run_mdct", "dct4", "encode_intensity_stereo", "find_scale_factor",
        "calc_scalefactors", "scale_spectra", "calc_hfr_scales",
        "calc_delta_lengths", "calc_resolution_enc", "calc_used_bits",
        "binary_search_level", "binary_search_boundary", "quantize_spectra",
        "encode")},
    **{f"ops.hca_frame:{n}": _HOST for n in (
        "UnpackedFrames.__init__", "calc_resolutions", "unpack_frames",
        "noise_lists", "fill_noise_frame", "pack_frame", "score_key",
        "test_frames_native", "pack_frames_native")},
    **{f"ops.hca_kernels:{n}": _ENGINE for n in (
        "hfr_static_of", "fused_transform_supported", "hca_decode_transform")},
    "ops.hca_kernels:hca_decode_transform_host": _HOST,
    "ops.hca_pack_device:DevicePacker.__init__": _ENGINE,
    "ops.hca_unpack_device:get_unpacker": _ENGINE,
    "ops.hca_unpack_device:unpack_frames_device": _ENGINE,
    **{f"ops.mp2_encode_device:{n}": _F32_LANE for n in (
        "make_config", "frame_padding", "mirror_from_spectra_np",
        "encode_from_spectra_np", "assemble_stream",
        "encode_mp2_device_batch")},
    "ops.mp2_frame:unpack": _HOST,
    "ops.mp2_frame:pack_frames": _HOST,
    **{f"ops.mp2_kernels:{n}": _HOST for n in (
        "dequantize_np", "synthesize_np", "analyze_np", "analyze_fast",
        "pcm16", "decode_pcm16_host")},
    **{f"ops.mp2_kernels:{n}": _ENGINE for n in (
        "decode_transform_device", "analyze_device",
        "dispatch_decode_batched", "decode_transform_device_batched")},
    "ops.mp2_tables:synthesis_matrices": _ENGINE,
    "ops.mp2_unpack_device:Mp2DeviceUnpacker.__init__": _ENGINE,
    "parallel.pipeline:pick_hca_engine": _PICK,
    **{f"utils.bitio:{n}": _HOST for n in (
        "BitReader.remaining", "BitReader.read_signed", "BitReader.align",
        "BitWriter.align", "unpack_fixed_codes", "pack_fixed_codes")},
}


def _port_module_name(name: str) -> str:
    return "pycricodecs_tpu_torch" + name[len("pycricodecs_tpu"):]


def _carried_modules() -> list:
    names = ["pycricodecs_tpu"] + [m.name for m in pkgutil.walk_packages(
        J.__path__, "pycricodecs_tpu.")]
    out = []
    for name in names:
        try:
            spec = importlib.util.find_spec(_port_module_name(name))
        except ModuleNotFoundError:
            spec = None
        if spec is not None:
            out.append(name)
    return out


def _function(obj):
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    return obj if inspect.isfunction(obj) else None


def _callables() -> dict:
    """{"module:qualname" (module relative to the package): (module,
    attribute path)} of every public JAX function, class method and
    __init__ defined in a carried module."""
    out = {}
    for mod in _carried_modules():
        m = importlib.import_module(mod)
        short = mod[len("pycricodecs_tpu."):] or "."
        for name, obj in vars(m).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod:
                continue
            if inspect.isfunction(obj):
                out[f"{short}:{name}"] = (mod, (name,))
            elif inspect.isclass(obj):
                for attr, member in vars(obj).items():
                    if (attr.startswith("_") and attr != "__init__") \
                            or _function(member) is None:
                        continue
                    out[f"{short}:{name}.{attr}"] = (mod, (name, attr))
    return out


CALLABLES = _callables()


def _resolve(mod: str, path: tuple, port: bool):
    m = importlib.import_module(_port_module_name(mod) if port else mod)
    obj = getattr(m, path[0], None)
    if obj is None or len(path) == 1:
        return obj
    return _function(inspect.getattr_static(obj, path[1], None))


def _positional(sig) -> list:
    return [p.name for p in sig.parameters.values()
            if p.kind in (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)]


def signature_faults(jax_fn, port_fn) -> list:
    """What in port_fn's signature breaks the rule for a JAX call of
    jax_fn (empty when nothing does)."""
    js, ps = inspect.signature(jax_fn), inspect.signature(port_fn)
    jpos, ppos = _positional(js), _positional(ps)
    faults = []
    if ppos != jpos[:len(ppos)]:
        faults.append(f"positional parameters {ppos} are not the JAX "
                      f"{jpos} by name and place")
    kinds = {p.kind for p in ps.parameters.values()}
    if P.VAR_POSITIONAL in kinds and P.VAR_POSITIONAL not in {
            p.kind for p in js.parameters.values()}:
        faults.append("takes *args where the JAX callable does not")
    for name, p in js.parameters.items():
        if p.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD):
            continue
        q = ps.parameters.get(name)
        if name in DEPARTURES:
            if not (q is None or q.kind == P.KEYWORD_ONLY
                    or (name in SAME_MEANING and name in ppos)):
                faults.append(f"departure {name!r} is not keyword-only")
        elif q is None and P.VAR_KEYWORD not in kinds:
            faults.append(f"does not accept the JAX parameter {name!r}")
        elif q is not None and q.kind == P.POSITIONAL_ONLY:
            faults.append(f"{name!r} cannot be passed by keyword")
    return faults


def test_the_walk_reaches_the_public_surface():
    """The computed module list holds the entry points' modules, and the
    walk finds the callables this rule was written for."""
    mods = set(_carried_modules())
    for mod in ("pycricodecs_tpu.models.adx", "pycricodecs_tpu.models.ahx",
                "pycricodecs_tpu.models.hca", "pycricodecs_tpu.parallel.pipeline",
                "pycricodecs_tpu.ops.hca_encode_device",
                "pycricodecs_tpu.containers.cpk", "pycricodecs_tpu.cricodecs"):
        assert mod in mods
    assert "pycricodecs_tpu.native" not in mods
    for name in ("models.adx:decode", "models.adx:encode",
                 "models.ahx:encode_mp2", "parallel.pipeline:decode_awb",
                 "parallel.pipeline:decode_acb",
                 "ops.hca_encode_device:encode_batch_device",
                 "containers.cpk:CPK.__init__", "models.adx:ADX.encode"):
        assert name in CALLABLES
    assert len(CALLABLES) > 200


@pytest.mark.parametrize("name", sorted(CALLABLES))
def test_port_signature_keeps_the_jax_calls(name):
    mod, path = CALLABLES[name]
    port_fn = _resolve(mod, path, port=True)
    if port_fn is None:
        assert name in NOT_CARRIED, f"{name}: not in the port"
        return
    assert name not in NOT_CARRIED, f"{name}: carried, yet listed"
    assert signature_faults(_resolve(mod, path, port=False), port_fn) == []


def test_not_carried_lists_only_jax_callables():
    assert set(NOT_CARRIED) <= set(CALLABLES)


def _fn(a, b=1, *, c=2):
    pass


@pytest.mark.parametrize("port_src, fault", [
    ("def f(a, b=1, *, c=2): pass", None),
    ("def f(a, *, b=1, c=2): pass", None),
    ("def f(a, b=1, x=0, *, c=2): pass", "positional"),
    ("def f(a, x=0, b=1, *, c=2): pass", "positional"),
    ("def f(x, b=1, *, c=2): pass", "positional"),
    ("def f(a, b=1): pass", "'c'"),
    ("def f(a, b=1, *args, c=2): pass", "*args"),
    ("def f(a, b=1, **kw): pass", None),
], ids=["same", "keyword_only", "extra_positional", "shifted", "renamed",
        "missing", "star_args", "var_keyword"])
def test_the_rule_catches_each_kind_of_mismatch(port_src, fault):
    """The check itself: a positional parameter added, moved or renamed,
    a JAX parameter dropped, or *args fails it."""
    scope = {}
    exec(port_src, scope)
    got = signature_faults(_fn, scope["f"])
    if fault is None:
        assert got == []
    else:
        assert any(fault in f for f in got), got


def test_departures_are_keyword_only_or_absent():
    def jax(data, device=False, mesh=None, engine="auto"):
        pass

    def good(data, *, device="cuda", mesh=None):
        pass

    def bad(data, device="cuda", *, mesh=None):
        pass

    def meshed(data, device=False, mesh=None, *, engine="auto"):
        pass

    assert signature_faults(jax, good) == []
    assert any("'device'" in f for f in signature_faults(jax, bad))
    assert signature_faults(meshed, good) == []
