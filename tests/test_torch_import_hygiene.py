"""The PyTorch port must import neither JAX nor the JAX package: the machine
with the card has neither."""

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
             if m == "jax" or m.startswith("jax.")
             or m == "eventgpt_tpu" or m.startswith("eventgpt_tpu."))
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
            "eventgpt_tpu_torch.cli.serve"} <= set(found["modules"])
    assert found["bad"] == [], f"the port pulled in: {found['bad']}"
