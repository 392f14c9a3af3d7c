"""The port stands alone: no jax, nothing of ``repro``, no silent CPU runs."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.cluster import cluster_network, simulate_cluster
from repro_torch.configs.registry import get_config
from repro_torch.core import policy_models
from repro_torch.core.simulator import simulate_network
from repro_torch.hierarchy import hierarchy_network, simulate_hierarchy
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.serving import Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name == "repro" or name.startswith("repro."))


def test_every_module_imports_without_jax_or_repro():
    mods = _port_modules()
    for name in ("kernels.replay", "kernels.event_sim", "kernels.cache_update",
                 "kernels.ops", "obs.trace", "obs.metrics", "obs.export",
                 "kernels.flash_attention", "kernels.paged_attention",
                 "kernels.linear_scan", "models.rwkv", "core.classify",
                 "latency", "latency.analytic", "latency.forecast",
                 "models.config", "models.layers", "models.attention",
                 "models.transformer", "configs.registry", "configs.rwkv6_7b",
                 "configs.internlm2_1_8b", "cache.py_ref", "serving.kv_pages",
                 "serving.prefix_cache", "serving.engine", "training.data",
                 "launch.serve", "cluster", "cluster.hashing",
                 "cluster.model", "cluster.sim", "core.py_sim", "hierarchy",
                 "hierarchy.model", "hierarchy.sim"):
        assert f"repro_torch.{name}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    cfg = get_config("internlm2-1.8b", reduced=True)
    params = transformer.init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = policy_models.lru_network()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_network(net, [0.5], n_requests=10, seeds=(0,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_network(net, [0.5], n_requests=10, seeds=(0,),
                         coalesce_flows=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_network(net, [0.5], n_requests=10, seeds=(0,),
                         arrival_rate=0.1)
    cm = cluster_network("lru", 2, mpl=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_cluster(cm, [0.5], n_requests=10, seeds=(0,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_cluster(cm, [0.5], n_requests=10, seeds=(0,),
                         coalesce_flows=4)
    hm = hierarchy_network("lru", "lru", n_clients=2, n_shards=2, mpl=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_hierarchy(hm, [0.5], n_requests=10, seeds=(0,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_hierarchy(hm, [0.5], n_requests=10, seeds=(0,),
                           coalesce_flows=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.forward(params, [[1, 2, 3]], cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params, ServeConfig())
    rcfg = get_config("rwkv6-7b", reduced=True)
    rparams = transformer.init_params(rcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.forward(rparams, [[1, 2, 3]], rcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(rcfg, rparams, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "rwkv6-7b", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu").type == "cpu"
