"""Sign / verify tools: ``python -m dvdx_tpu_torch keys ...``.

Counterpart of ``dvdx_tpu/verify/cli.py``, with the same keys, signatures
and verdicts: Ed25519 with a seed-derived keypair, the message framed as
``<Bytes>message</Bytes>`` as substrate-style signers frame it.

  python -m dvdx_tpu_torch keys keygen --seed "my miner" --out key.json
  python -m dvdx_tpu_torch keys sign --key key.json --message "hello"
  python -m dvdx_tpu_torch keys verify --pubkey <hex> --message "hello" --signature <hex>
"""

from __future__ import annotations

import argparse
import json
import sys

from .proof import Keypair, verify_signature


def _wrap(message: str) -> bytes:
    return f"<Bytes>{message}</Bytes>".encode("utf-8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch keys",
                                 description="dvdx signature tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("keygen")
    g.add_argument("--seed", required=True)
    g.add_argument("--out", default="")
    s = sub.add_parser("sign")
    s.add_argument("--key", default="")
    s.add_argument("--seed", default="")
    s.add_argument("--message", required=True)
    v = sub.add_parser("verify")
    v.add_argument("--pubkey", required=True)
    v.add_argument("--message", required=True)
    v.add_argument("--signature", required=True)
    args = ap.parse_args(argv)

    if args.cmd == "keygen":
        out = {"pubkey": Keypair.from_seed(args.seed.encode()).public_bytes.hex(),
               "seed": args.seed}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=2)
        print(json.dumps({"pubkey": out["pubkey"]}))
        return 0
    if args.cmd == "sign":
        if args.key:
            with open(args.key) as f:
                seed = json.load(f)["seed"]
        elif args.seed:
            seed = args.seed
        else:
            print("need --key or --seed", file=sys.stderr)
            return 2
        kp = Keypair.from_seed(seed.encode())
        print(json.dumps({"pubkey": kp.public_bytes.hex(),
                          "signature": kp.sign(_wrap(args.message)).hex()}))
        return 0
    ok = verify_signature(bytes.fromhex(args.pubkey), _wrap(args.message),
                          bytes.fromhex(args.signature))
    print(json.dumps({"valid": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
