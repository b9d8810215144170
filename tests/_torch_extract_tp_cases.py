"""The ranks' side of the tensor-parallel checks of
tests/test_torch_extract_split.py on two gloo CPU ranks: the decoder
factory with ``tp=2`` on one batch, then ``extract --batched --tp 2`` as
``torchrun`` launches it, on the inputs the test wrote
(``<workdir>/inputs.pt``). Imports the port only."""

import torch
import torch.distributed as dist

from wealy_tpu_torch.cli import extract_batched as TEB
from wealy_tpu_torch.train.config import Config

from _torch_mesh_cases import _cli


def run(ports, workdir) -> dict:
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    rank, world = dist.get_rank(), dist.get_world_size()
    fn = TEB.make_decoder_embed_fn(Config.from_dict(inp["conf"]), inp["ckpt"], max_len=8, tp=2,
                                   device="cpu")
    hidden, lengths = fn(inp["audio"])
    res = {"factory": (hidden.float(), lengths)}
    dist.barrier()
    dist.destroy_process_group()
    res["cli"] = _cli(inp["argv"], ports[1], rank, world)
    return res
