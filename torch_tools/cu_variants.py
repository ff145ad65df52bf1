"""A CUDA source of the port rebuilt with some of its lines replaced: the
variants that torch_tools/segment_variants.py (csrc/segment.cu) and
torch_tools/gat_bwd_walk.py (csrc/gat_bwd.cu) time against the package's
own build.  A rule is (text of the source, its replacement); a variant is a
list of rules, each of whose texts must be in the source exactly once, so
that a variant measures the source as it stands.
"""

import ctypes
import os
import subprocess


def variant_source(cu, source, rules):
    """`source` (the text of csrc/<cu>) with each rule of `rules` applied;
    RuntimeError where a rule's text is not in it exactly once."""
    for old, new in rules:
        if source.count(old) != 1:
            raise RuntimeError(f"csrc/{cu} does not hold {old!r} exactly once")
        source = source.replace(old, new)
    return source


def build(cu, variants):
    """{name: CDLL}: csrc/<cu> with each variant's rules ({name: rules}),
    built with the port's nvcc flags into the package's
    _build/variants/, one nvcc a variant, all started together."""
    from graph_recsys_benchmark_tpu_torch.ops import _cuda

    out_dir = os.path.join(_cuda.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_cuda.CSRC, cu)) as f:
        source = f.read()
    stem = os.path.splitext(cu)[0]
    procs = {}
    try:
        for i, (name, rules) in enumerate(variants.items()):
            path, so = (os.path.join(out_dir, f"{stem}_v{i}{ext}") for ext in (".cu", ".so"))
            with open(path, "w") as f:
                f.write(variant_source(cu, source, rules))
            procs[name] = (subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC, "-o", so, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
        libs, failed = {}, []
        for name, (proc, so) in procs.items():
            log = proc.communicate(timeout=_cuda.BUILD_TIMEOUT_S)[0]
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                libs[name] = ctypes.CDLL(so)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for\n" + "\n".join(failed))
    return libs


def entry(lib, name):
    """C entry `name` of a variant's library, typed as the package's."""
    from graph_recsys_benchmark_tpu_torch.ops import _cuda

    fn = getattr(lib, name)
    fn.argtypes = _cuda._SIGNATURES[name][1]
    fn.restype = ctypes.c_int
    return fn
