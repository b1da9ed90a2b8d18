"""Check the port's install route, which needs no download.

    python -m ss_asr_tpu_torch.install_check [--prefix DIR]

Installs this checkout into a scratch prefix with ``pip install --no-deps
--no-build-isolation --prefix DIR .`` (what the port needs, ``torch``,
``numpy`` and ``pyyaml``, must already be installed; ``--no-deps`` keeps pip
from fetching the JAX package's dependencies, and ``--no-build-isolation``
builds with the setuptools already installed instead of downloading one),
then runs every ``ss-asr-torch-*`` console script of ``pyproject.toml`` with
``--help`` from outside the checkout, on the installed copy.  Prints one
line a script and exits non-zero if the install or any script fails; says
so when setuptools is missing.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import sysconfig
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def torch_scripts(pyproject: str) -> list:
    """The ``ss-asr-torch-*`` names of ``[project.scripts]``."""
    import tomllib

    with open(pyproject, "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return sorted(n for n in scripts if n.startswith("ss-asr-torch-"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ss_asr_tpu_torch.install_check")
    parser.add_argument("--prefix", default=None, help="install prefix (default: a temp dir)")
    args = parser.parse_args(argv)
    if importlib.util.find_spec("setuptools") is None:
        print("install check: setuptools is missing, so pip cannot build the checkout without "
              "a download", flush=True)
        return 2
    prefix = args.prefix or tempfile.mkdtemp(prefix="ss_asr_install_")
    cmd = [sys.executable, "-m", "pip", "install", "--no-deps", "--no-build-isolation",
           "--no-index", "--prefix", prefix, ROOT]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(f"install check: {' '.join(cmd[2:])} -> exit {proc.returncode}", flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-2000:] + proc.stderr[-2000:], flush=True)
        return 1
    site = sysconfig.get_path("purelib", vars={"base": prefix, "platbase": prefix})
    env = {**os.environ, "PYTHONPATH": site, "PATH": os.path.join(prefix, "bin") + os.pathsep
           + os.environ.get("PATH", "")}
    bad = 0
    with tempfile.TemporaryDirectory() as away:  # outside the checkout: the installed copy
        for name in torch_scripts(os.path.join(ROOT, "pyproject.toml")):
            run = subprocess.run([os.path.join(prefix, "bin", name), "--help"], cwd=away,
                                 env=env, capture_output=True, text=True)
            ok = run.returncode == 0 and "usage" in run.stdout.lower()
            bad += not ok
            print(f"install check: {name} --help -> exit {run.returncode}"
                  + ("" if ok else f": {run.stderr[-600:]}"), flush=True)
        where = subprocess.run([sys.executable, "-c", "import ss_asr_tpu_torch; "
                                "print(ss_asr_tpu_torch.__file__)"], cwd=away, env=env,
                               capture_output=True, text=True).stdout.strip()
    print(f"install check: ss_asr_tpu_torch imports from {where}; "
          f"{'all scripts ran' if not bad else f'{bad} scripts failed'}", flush=True)
    return 1 if bad or not where.startswith(prefix) else 0


if __name__ == "__main__":
    sys.exit(main())
