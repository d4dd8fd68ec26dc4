#!/usr/bin/env python3
"""Compare the SASS of every kernel library of two trees of the port,
kernel by kernel:

    python3 experiments/sass_compare.py OLD_TREE NEW_TREE [LIB ...]

Builds the libraries (``paddle_tpu_torch/kernels/_build.py``'s
``SOURCES``, or the LIBs named) of both trees side by side, each into
its own ``build/kernels/``, disassembles them with ``cuobjdump -sass``
and compares each kernel's instructions. The two trees' sources have
the same file names, so their kernels' mangled names agree except for
the anonymous-namespace hash, which is normalised away. Prints one JSON
line per library: kernels in both, how many are identical, the names
of those that differ, and the kernels only one tree has.
"""
import json
import os
import re
import shutil
import subprocess
import sys

BUILD = ("import sys; sys.path.insert(0, '.'); "
         "from paddle_tpu_torch.kernels import _build; "
         "_build.build_all({names})")


def cuobjdump():
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        sys.exit("cuobjdump not found")
    return path


def _normalise(text):
    """Names in an anonymous namespace carry hashes of the source's path
    (``_GLOBAL__N__<hex>_<len>_<file>_cu_<hex>``, ``_INTERNAL_<hex>_``),
    and cuobjdump pads a line's encoding comment to the library's longest
    instruction: two trees may differ there alone."""
    text = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__", text)
    text = re.sub(r"(_cu)_[0-9a-f]{8}", r"\1", text)
    text = re.sub(r"_INTERNAL_[0-9a-f]+_", "_INTERNAL_", text)
    return " ".join(text.split())


def kernels(lib):
    """{normalised kernel name: its SASS lines} of one shared library:
    the lines from a kernel's ``Function :`` header to the next one, or
    to the end of its ELF section."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    found, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _normalise(m.group(1))
            found[name] = []
        elif re.match(r"\s*(Fatbin|arch =|code version|host =|"
                      r"compile_size|identifier)", line):
            name = None
        elif name is not None and line.strip():
            found[name].append(_normalise(line.strip()))
    return found


def main():
    trees = [os.path.abspath(t) for t in sys.argv[1:3]]
    if len(trees) != 2:
        sys.exit(__doc__)
    sys.path.insert(0, trees[1])
    from paddle_tpu_torch.kernels import _build
    names = sys.argv[3:] or list(_build.SOURCES)
    procs = [subprocess.Popen([sys.executable, "-c",
                               BUILD.format(names=names)], cwd=t)
             for t in trees]
    if any(p.wait() for p in procs):
        sys.exit("a build failed")
    for name in names:
        old, new = (kernels(os.path.join(t, "build", "kernels",
                                         name + ".so")) for t in trees)
        both = sorted(set(old) & set(new))
        differ = [k for k in both if old[k] != new[k]]
        first = None
        if differ:   # the first lines that differ, for a reader
            a, b = old[differ[0]], new[differ[0]]
            first = [(x, y) for x, y in zip(a, b) if x != y][:4] or \
                [f"{len(a)} against {len(b)} lines"]
        print(json.dumps(dict(
            library=name, kernels_in_both=len(both),
            identical=len(both) - len(differ), differ=differ[:8],
            n_differ=len(differ), first_difference=first,
            only_old=sorted(set(old) - set(new))[:8],
            only_new=len(set(new) - set(old)))), flush=True)


if __name__ == "__main__":
    main()
