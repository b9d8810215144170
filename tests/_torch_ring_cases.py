"""The ranks' side of tests/test_torch_ring.py: ring attention on the
(data, cp) meshes of the world, with a key mask, composed with data
parallelism, in bf16, and its gradients, on the inputs the test wrote
(``<workdir>/inputs.pt``). Imports the port only."""

import torch
import torch.distributed as dist

from wealy_tpu_torch.parallel.ring import make_cp_mesh, ring_attention


def run(ports, workdir) -> dict:
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    n = dist.get_world_size()
    ring = make_cp_mesh(n, device="cpu")
    res = {"world": n}
    with torch.no_grad():
        res["plain"] = ring_attention(*inp["plain"], inp["plain_scale"], ring)
        res["mask"] = ring_attention(*inp["mask_qkv"], 0.25, ring, kv_mask=inp["mask"])
        res["bf16"] = ring_attention(*(x.bfloat16() for x in inp["mask_qkv"]), 0.25,
                                     ring).float()
        if n == 4:
            res["dp"] = ring_attention(*inp["dp_qkv"], 0.3, make_cp_mesh(2, n_data=2,
                                                                         device="cpu"))
    q, k, v = (x.clone().requires_grad_(True) for x in inp["grad_qkv"])
    loss = (ring_attention(q, k, v, 0.5, ring) * inp["grad_w"]).sum()
    res["grads"] = torch.autograd.grad(loss, (q, k, v))
    return res
