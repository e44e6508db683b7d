"""Cluster-free mock network, and adversarial miners.

Counterpart of ``dvdx_tpu/network/mock.py``: ``build_mock_network`` puts N
miners, a validator, a ledger and a ``MockTransport`` in one process. The
miners run the real generation and proof path over the real wire format;
only the sockets are emulated. The adversaries are the tamper models of the
protocol's security analysis:

* ``LazyMiner`` fabricates eps for its last steps (re-execution catches it);
* ``WrongVideoMiner`` delivers an unrelated video over an honest trace (the
  video binding catches it);
* ``WrongSeedMiner`` ignores the validator's seed (the base-noise check
  catches it);
* ``ApproxMiner`` runs a mantissa-truncated copy of the UNet (only a
  re-execution tolerance below its error catches it).

On a CUDA pipeline the network turns on deterministic algorithms
(``dvdx_tpu_torch.enable_determinism``): the same-program regime rests on
re-executed steps reproducing their leaves.

    python -m dvdx_tpu_torch.network.mock --device cpu [--adversaries lazy,wrong_video]
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import List, Optional

import numpy as np
import torch

from .. import enable_determinism
from ..pipelines.text2video import Pipeline, build_pipeline
from ..utils.testing import perturb_zero_params
from ..utils.video_io import encode_mp4
from ..verify.merkle import MerkleCommitment
from ..verify.proof import Keypair, sign_proof
from .base import Registry
from .ledger import Ledger, prompt_commitment
from .miner import Miner
from .transport import MockTransport, WANProfile
from .validator import Validator, ValidatorConfig


class LazyMiner(Miner):
    """Commits to fabricated eps for the last ``tamper_steps`` steps; the
    Merkle tree and the signature stay valid, so only re-execution catches
    it."""

    def __init__(self, *args, tamper_steps: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.tamper_steps = tamper_steps

    def _generate_with_proof(self, req):
        resp = super()._generate_with_proof(req)
        com = self._proofs[req.request_id]
        m = min(self.tamper_steps, len(com.timesteps))
        rng = np.random.default_rng(0)
        epss = com.epss.clone()
        for i in range(len(epss) - m, len(epss)):
            fake = rng.normal(0, 1, tuple(epss[i].shape)).astype(np.float32)
            epss[i] = torch.from_numpy(fake).to(epss.dtype)
        tampered = MerkleCommitment(com.timesteps, com.zs, epss)
        self._proofs[req.request_id] = tampered
        resp.merkle_root = tampered.root
        resp.signature = sign_proof(self.keypair, req.challenge, req.seed, resp.video,
                                    tampered.root)
        return resp


class WrongVideoMiner(Miner):
    """An honest trace and signature over an unrelated video (re-signed over
    the substitute's digest); only the video binding catches it."""

    def _generate_with_proof(self, req):
        resp = super()._generate_with_proof(req)
        rng = np.random.default_rng(1234)
        fake = rng.integers(0, 255, (req.num_frames, req.height, req.width, 3),
                            dtype=np.uint8)
        resp.video = encode_mp4(fake, fps=req.fps or 8)
        resp.video_sha256 = hashlib.sha256(resp.video).digest()
        resp.signature = sign_proof(self.keypair, req.challenge, req.seed, resp.video,
                                    resp.merkle_root)
        return resp


class WrongSeedMiner(Miner):
    """Ignores the validator's seed and echoes it back; the base-noise check
    catches it."""

    def _generate_with_proof(self, req):
        bad_req = dataclasses.replace(req, seed=(req.seed + 1) & 0xFFFFFFFFFFFFFFFF)
        resp = super()._generate_with_proof(bad_req)
        resp.seed = req.seed
        resp.signature = sign_proof(self.keypair, req.challenge, req.seed, resp.video,
                                    resp.merkle_root)
        return resp


@torch.no_grad()
def truncate_mantissa(module: torch.nn.Module, keep_bits: int) -> torch.nn.Module:
    """Zero all but ``keep_bits`` mantissa bits of every bfloat16 (of 7) and
    float32 (of 23) parameter, in place, through integer views: a stand-in
    for cheap reduced-precision inference."""
    for p in module.parameters():
        if p.dtype == torch.bfloat16:
            mask = np.uint16((0xFFFF << max(0, 7 - keep_bits)) & 0xFFFF).view(np.int16)
            p.view(torch.int16).bitwise_and_(int(mask))
        elif p.dtype == torch.float32:
            mask = np.uint32((0xFFFFFFFF << max(0, 23 - keep_bits))
                             & 0xFFFFFFFF).view(np.int32)
            p.view(torch.int32).bitwise_and_(int(mask))
    return module


class ApproxMiner(Miner):
    """Runs the real pipeline with a mantissa-truncated copy of its UNet.
    Its trace is self-consistent (Merkle, signature, base noise, z chain and
    video binding all hold), so only a re-execution tolerance below its
    error catches it. The shared pipeline is not touched."""

    def __init__(self, pipeline: Pipeline, *args, keep_mantissa_bits: int = 2, **kwargs):
        cheap_unet = truncate_mantissa(copy.deepcopy(pipeline.unet), keep_mantissa_bits)
        cheap = Pipeline(pipeline.spec, cheap_unet, pipeline.text_encoder,
                         pipeline.vae_decoder, pipeline.tokenizer)
        super().__init__(cheap, *args, **kwargs)


ADVERSARIES = {"honest": Miner, "lazy": LazyMiner, "wrong_seed": WrongSeedMiner,
               "wrong_video": WrongVideoMiner, "approx": ApproxMiner}


@dataclasses.dataclass
class MockNetwork:
    registry: Registry
    ledger: Ledger
    transport: MockTransport
    validator: Validator
    miners: List[Miner]

    async def run_request(self, request_id: str, prompt: str, user: str = "user",
                          deposit: int = 20000):
        """Full lifecycle: deposit and commit, one round, rewards."""
        self.ledger.mint(user, deposit)
        self.ledger.deposit_and_commit(user, request_id, prompt_commitment(prompt), deposit)
        if not self.ledger.verify_prompt(request_id, prompt):
            raise RuntimeError("prompt commitment does not verify")
        return await self.validator.run_round(request_id, prompt)


def build_mock_network(n_miners: int = 3, adversaries: Optional[List[str]] = None,
                       pipeline: Optional[Pipeline] = None,
                       wan: Optional[WANProfile] = None,
                       validator_config: Optional[ValidatorConfig] = None,
                       stake: int = 10_000, seed: int = 0, device="cuda",
                       validator_pipeline: Optional[Pipeline] = None,
                       mesh=None, mesh_strategy: Optional[str] = None) -> MockNetwork:
    """Miners (``adversaries[i]`` names miner i's kind, honest by default)
    over ``pipeline``, or over a seeded ``zeroscope-tiny`` built on
    ``device`` with its zero leaves perturbed. Each miner pins its engine's
    platform tag at registration. The validator runs on
    ``validator_pipeline`` where given (the same weights on another device,
    say), else on the miners' pipeline. With ``mesh`` (a
    ``parallel.mesh.Mesh``; its other ranks follow, ``StepEngine.follow``)
    and / or ``mesh_strategy`` the miners generate through that strategy's
    program (fsdp by default on a mesh, as in the JAX package)."""
    adversaries = adversaries or []
    if pipeline is None:
        pipeline = perturb_zero_params(build_pipeline("zeroscope-tiny", seed=seed,
                                                      device=device), seed=99)
    validator_pipeline = validator_pipeline or pipeline
    if "cuda" in (pipeline.device.type, validator_pipeline.device.type):
        enable_determinism()

    registry = Registry()
    ledger = Ledger()
    transport = MockTransport(wan=wan, seed=seed)
    miners: List[Miner] = []
    for i in range(n_miners):
        kind = adversaries[i] if i < len(adversaries) else "honest"
        # a mesh miner's engine shards its pipeline in place: each gets its
        # own copy, so the validator and the other miners keep theirs whole
        miner_pipe = copy.deepcopy(pipeline) if mesh is not None else pipeline
        miner = ADVERSARIES[kind](miner_pipe, Keypair.from_seed(f"miner-{i}".encode()),
                                  registry, mesh=mesh, strategy=mesh_strategy)
        addr = f"mock://miner-{i}"
        uid = miner.register(addr, stake=stake, platform=miner.platform_tag)
        ledger.mint(f"miner-{uid}", stake)
        ledger.stake(f"miner-{uid}", stake)
        transport.serve(addr, miner.handle)
        miners.append(miner)

    validator = Validator(validator_pipeline, Keypair.from_seed(b"validator-0"), registry,
                          transport, ledger, validator_config or ValidatorConfig())
    validator.register("mock://validator", stake=stake * 10)
    return MockNetwork(registry=registry, ledger=ledger, transport=transport,
                       validator=validator, miners=miners)


def demo(argv=None) -> dict:
    """deposit -> generation -> verification -> rewards in one process over
    zeroscope-tiny; prints and returns the round's summary (the report and
    videos go to a temporary directory)."""
    import argparse
    import asyncio
    import json
    import tempfile

    ap = argparse.ArgumentParser(description="dvdx_tpu_torch mock network demo")
    ap.add_argument("--miners", type=int, default=3)
    ap.add_argument("--adversaries", default="",
                    help="comma list: lazy | wrong_seed | wrong_video | approx")
    ap.add_argument("--prompt", default="a red panda climbing a snowy tree")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = ValidatorConfig(sample_size=args.miners, num_checkpoints=args.steps,
                              num_frames=2, width=32, height=32, num_steps=args.steps,
                              results_dir=tmp)
        net = build_mock_network(n_miners=args.miners,
                                 adversaries=[a for a in args.adversaries.split(",") if a],
                                 validator_config=cfg, device=args.device)
        report = asyncio.new_event_loop().run_until_complete(
            net.run_request("demo", args.prompt))
    out = {"prompt": args.prompt, "device": str(net.validator.pipeline.device),
           "miners": {uid: {"score": round(d["score"], 3),
                            "cheat": d.get("cheat", False),
                            "failed_check": d.get("failed_check"),
                            "bitwise": d.get("reexec_bitwise")}
                      for uid, d in report["miners"].items()},
           "ledger": net.ledger.snapshot()["requests"]["demo"]["status"],
           "stakes": dict(net.ledger.stakes)}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    demo()
