"""The PyTorch port must import neither JAX nor the JAX package: the machine
with the card has neither. Nor may it import the HF stack (``safetensors``,
``transformers``, ``sentencepiece``, ``tokenizers``), which that machine
lacks too: a static scan finds such an import even inside a function,
where importing the modules cannot."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import eventgpt_tpu_torch
names = ["eventgpt_tpu_torch"]
for info in pkgutil.walk_packages(eventgpt_tpu_torch.__path__, "eventgpt_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "eventgpt_tpu", "safetensors", "transformers",
                                    "sentencepiece", "tokenizers"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    found = json.loads(res.stdout.strip().splitlines()[-1])
    # Every submodule was imported, the kernel wrappers, the server and the CLIs
    # among them.
    assert {"eventgpt_tpu_torch.ops.flash_attention",
            "eventgpt_tpu_torch.ops.int4_matmul",
            "eventgpt_tpu_torch.ops.decode_attention",
            "eventgpt_tpu_torch.ops.quant",
            "eventgpt_tpu_torch.serve",
            "eventgpt_tpu_torch.serve_blocks",
            "eventgpt_tpu_torch.workload",
            "eventgpt_tpu_torch.faults",
            "eventgpt_tpu_torch.fleet",
            "eventgpt_tpu_torch.rpc",
            "eventgpt_tpu_torch.fleet_proc",
            "eventgpt_tpu_torch.cli.infer",
            "eventgpt_tpu_torch.cli.serve",
            "eventgpt_tpu_torch.cli.export",
            "eventgpt_tpu_torch.checkpoint",
            "eventgpt_tpu_torch.models._safetensors",
            "eventgpt_tpu_torch.models.qformer",
            "eventgpt_tpu_torch.train.lora",
            "eventgpt_tpu_torch.train.optim",
            "eventgpt_tpu_torch.train.data",
            "eventgpt_tpu_torch.train.steps",
            "eventgpt_tpu_torch.train.trainer",
            "eventgpt_tpu_torch.train.medusa",
            "eventgpt_tpu_torch.data.motion_corpus",
            "eventgpt_tpu_torch.scripts.train_medusa",
            "eventgpt_tpu_torch.scripts.medusa_acceptance",
            "eventgpt_tpu_torch.scripts.int4_decode_ab",
            "eventgpt_tpu_torch.cli.train",
            "eventgpt_tpu_torch.obs",
            "eventgpt_tpu_torch.obs.metrics",
            "eventgpt_tpu_torch.obs.trace",
            "eventgpt_tpu_torch.obs.journey",
            "eventgpt_tpu_torch.obs.memory",
            "eventgpt_tpu_torch.obs.series",
            "eventgpt_tpu_torch.obs.profiling",
            "eventgpt_tpu_torch.native",
            "eventgpt_tpu_torch.cli.eval",
            "eventgpt_tpu_torch.data.dsec",
            "eventgpt_tpu_torch.data.feature_track",
            "eventgpt_tpu_torch.scripts.stream_demo",
            "eventgpt_tpu_torch.parallel",
            "eventgpt_tpu_torch.parallel.mesh",
            "eventgpt_tpu_torch.parallel.dist",
            "eventgpt_tpu_torch.parallel.sharding",
            "eventgpt_tpu_torch.parallel.serving",
            "eventgpt_tpu_torch.parallel.autograd",
            "eventgpt_tpu_torch.parallel.sp_common",
            "eventgpt_tpu_torch.parallel.ring",
            "eventgpt_tpu_torch.parallel.ulysses",
            "eventgpt_tpu_torch.parallel.multiproc",
            "eventgpt_tpu_torch.scripts.serve_demo"} <= set(found["modules"])
    assert found["bad"] == [], f"the port pulled in: {found['bad']}"


FORBIDDEN = ("jax", "eventgpt_tpu", "safetensors", "transformers", "sentencepiece", "tokenizers")


def _imported_roots(tree):
    """(line, top-level module name) of every import in a module's AST,
    those inside functions and ``__import__``/``import_module`` calls with
    a literal name included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("__import__", "import_module")):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_port_source_names_no_forbidden_import():
    root = os.path.join(REPO, "eventgpt_tpu_torch")
    found, scanned = [], 0
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            scanned += 1
            found += [f"{os.path.relpath(path, REPO)}:{line} imports {mod}"
                      for line, mod in _imported_roots(tree) if mod in FORBIDDEN]
    assert scanned > 30
    assert found == [], found


def test_mesh_rank_bodies_name_no_jax_import():
    """The mesh tests' rank processes run the port alone: the modules they
    execute name no JAX import, lazy ones included."""
    found = []
    for name in ("torch_mesh_ranks.py", "torch_mesh_serve.py", "torch_mesh_train.py"):
        path = os.path.join(REPO, "tests", name)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        found += [f"tests/{name}:{line} imports {mod}" for line, mod in _imported_roots(tree)
                  if mod in FORBIDDEN]
    assert found == [], found


def test_the_scan_sees_lazy_imports():
    src = ("def f():\n    import safetensors.torch\n"
           "def g():\n    from transformers import AutoTokenizer\n"
           "h = __import__('sentencepiece')\n"
           "import importlib\nk = importlib.import_module('tokenizers')\n")
    assert {m for _, m in _imported_roots(ast.parse(src))} >= {
        "safetensors", "transformers", "sentencepiece", "tokenizers"}


def _fault_sites(tree):
    """(line, site) of every ``maybe_fail("site")`` call with a literal
    site in a module's AST."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", getattr(node.func, "id", None)) == "maybe_fail"
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def _scan(root, pattern=".py"):
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(pattern):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    yield path, ast.parse(f.read(), path)


def _armed_specs():
    """Every string literal of the port's tests (where fault specs live)."""
    out = set()
    for path, tree in _scan(os.path.join(REPO, "tests")):
        if os.path.basename(path).startswith("test_torch_"):
            out |= {n.value for n in ast.walk(tree)
                    if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    return out


def test_every_port_fault_site_is_a_jax_site_and_armed_by_a_test():
    """The port's counterpart of the JAX lint's rule 4: each fault site the
    port wires is one the JAX package wires, and some ``tests/test_torch_*``
    arms it (a ``site:`` clause in a spec), so its handling runs."""
    port = {}
    for path, tree in _scan(os.path.join(REPO, "eventgpt_tpu_torch")):
        for line, site in _fault_sites(tree):
            port.setdefault(site, f"{os.path.relpath(path, REPO)}:{line}")
    jax_sites = {site for _, tree in _scan(os.path.join(REPO, "eventgpt_tpu"))
                 for _, site in _fault_sites(tree)}
    assert {"serve.step", "serve.dispatch", "serve.loop", "fleet.replica_kill",
            "procfleet.rpc", "train.step"} <= set(port)
    assert not set(port) - jax_sites, {s: port[s] for s in set(port) - jax_sites}
    specs = _armed_specs()
    unarmed = {s: where for s, where in port.items()
               if not any(f"{s}:" in spec for spec in specs)}
    assert not unarmed, f"fault sites no test arms: {unarmed}"


def test_the_site_scan_sees_calls_and_specs():
    src = ("from x import faults\nfaults.maybe_fail('a.b')\nmaybe_fail(\"c.d\")\n"
           "faults.maybe_delay('e.f')\nfaults.maybe_fail(name)\n")
    assert [s for _, s in _fault_sites(ast.parse(src))] == ["a.b", "c.d"]
