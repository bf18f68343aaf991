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
            "eventgpt_tpu_torch.cli.train"} <= set(found["modules"])
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


def test_the_scan_sees_lazy_imports():
    src = ("def f():\n    import safetensors.torch\n"
           "def g():\n    from transformers import AutoTokenizer\n"
           "h = __import__('sentencepiece')\n"
           "import importlib\nk = importlib.import_module('tokenizers')\n")
    assert {m for _, m in _imported_roots(ast.parse(src))} >= {
        "safetensors", "transformers", "sentencepiece", "tokenizers"}
