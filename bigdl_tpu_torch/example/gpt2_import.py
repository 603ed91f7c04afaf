"""Import a GPT-2 state dict into TransformerLM and generate (port of
``bigdl_tpu/example/gpt2_import.py``, plus ``--device``).

    # a torch.save'd GPT2Model / GPT2LMHeadModel state dict:
    python -m bigdl_tpu_torch.example.gpt2_import --checkpoint gpt2.pth \\
        --vocab 50257 --hidden 768 --layers 12 --heads 12 --maxLen 1024 \\
        --prompt 464,3290,318 --maxNewTokens 16

    # a tiny random GPT-2 built with the transformers package, and
    # generation checked against its own greedy generate:
    python -m bigdl_tpu_torch.example.gpt2_import --demo --device cpu

Prompts and outputs are 0-based GPT-2 token ids.
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GPT-2 checkpoint -> TransformerLM")
    p.add_argument("--checkpoint", default=None, help="torch.save'd state dict")
    p.add_argument("--demo", action="store_true",
                   help="tiny self-contained parity demo (needs the "
                        "transformers package)")
    p.add_argument("--vocab", type=int, default=50257)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--maxLen", type=int, default=1024)
    p.add_argument("--prompt", default="464,3290,318",
                   help="comma-separated 0-based token ids")
    p.add_argument("--maxNewTokens", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def read_torch_checkpoint(path):
    """``torch.load`` a state-dict file (tensors only), unwrapping a
    ``state_dict`` or ``model`` wrapper key."""
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            return obj[key]
    return obj


def main(argv=None):
    """Import and generate; returns the generated 0-based ids."""
    args = build_parser().parse_args(argv)
    if not args.demo and not args.checkpoint:
        raise SystemExit("pass --checkpoint <file> or --demo")
    logging.basicConfig(level=logging.INFO)

    import numpy as np
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer.generate import generate
    from bigdl_tpu_torch.models.transformer.io import load_gpt2_state_dict

    if args.demo:
        args.vocab, args.hidden, args.layers, args.heads = 97, 32, 2, 2
        args.maxLen = 64
        args.prompt = "5,17,42"

    model = TransformerLM(vocab_size=args.vocab, hidden_size=args.hidden,
                          n_head=args.heads, n_layers=args.layers,
                          max_len=args.maxLen, dropout=0.0,
                          pos_encoding="learned", device=args.device)

    hf = None
    if args.demo:
        try:
            import transformers
        except ImportError as e:
            raise SystemExit("--demo needs the transformers package, which "
                             "is not installed; pass --checkpoint "
                             "<file>") from e
        torch.manual_seed(0)
        cfg = transformers.GPT2Config(
            vocab_size=args.vocab, n_positions=args.maxLen,
            n_embd=args.hidden, n_layer=args.layers, n_head=args.heads,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
        hf = transformers.GPT2LMHeadModel(cfg).eval()
        state_dict = hf.state_dict()
    else:
        state_dict = read_torch_checkpoint(args.checkpoint)
    load_gpt2_state_dict(model, state_dict)

    prompt_ids = [int(t) for t in args.prompt.split(",")]
    bad = [t for t in prompt_ids if not 0 <= t < args.vocab]
    if bad:
        raise SystemExit(f"prompt ids {bad} out of range for "
                         f"--vocab {args.vocab}")
    prompt0 = np.array([prompt_ids])
    out = generate(model, model.params, prompt0 + 1, args.maxNewTokens,
                   device=args.device)
    ids0 = (out.numpy() - 1)[0].tolist()
    print(f"prompt ids:    {ids0[:len(prompt_ids)]}")
    print(f"generated ids: {ids0[len(prompt_ids):]}")

    if hf is not None:
        with torch.no_grad():
            ref = hf.generate(torch.from_numpy(prompt0),
                              max_new_tokens=args.maxNewTokens,
                              do_sample=False, pad_token_id=0)
        match = ids0 == ref.numpy()[0].tolist()
        print(f"matches transformers' greedy generate: {match}")
        if not match:
            raise SystemExit(1)
    return ids0[len(prompt_ids):]


if __name__ == "__main__":
    main()
