"""Transformer language-model evaluation CLI (port of
``bigdl_tpu/models/transformer/test.py``: the same flags, plus
``--device``).  Loads a model saved by either package's train CLI,
reports the loss and the perplexity on held-out text, and with
``--generate N`` decodes N tokens from ``--prompt``.

    python -m bigdl_tpu_torch.models.transformer.test --model ckpt/model.3 \\
        --dictionary ckpt/dictionary.json --synthetic --generate 8
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None):
    """Evaluate; returns ``(results, generated words or None)``."""
    p = argparse.ArgumentParser(description="Evaluate transformer LM")
    p.add_argument("--model", required=True, help="trained model file")
    p.add_argument("--dictionary", default=None,
                   help="dictionary.json saved by the train CLI; without "
                        "it a dictionary is rebuilt from the input text, "
                        "which only matches the model for the SAME corpus")
    p.add_argument("-f", "--folder", default=None, help="input text file")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--vocabSize", type=int, default=4000)
    p.add_argument("--seqLength", type=int, default=24)
    p.add_argument("--packed", action="store_true",
                   help="evaluate on dense packed windows (must match how "
                        "the model was trained)")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after evaluation, decode N tokens from --prompt "
                        "and print them")
    p.add_argument("--prompt", default="the",
                   help="generation prompt (tokenized with the pipeline's "
                        "tokenizer)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch.dataset import text
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.transformer.generate import generate
    from bigdl_tpu_torch.models.utils import (SYNTH_CORPUS, lm_corpus,
                                              lm_dataset)
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import LocalValidator, Loss, PerplexityResult

    if args.synthetic or not args.folder:
        raw = SYNTH_CORPUS
    else:
        with open(args.folder) as f:
            raw = f.read()

    loaded = text.Dictionary.load(args.dictionary) if args.dictionary else None
    token_lists, dictionary = lm_corpus(raw, args.vocabSize,
                                        dictionary=loaded)
    ds = lm_dataset(token_lists, dictionary, args.seqLength, args.batchSize,
                    packed=args.packed)

    model = TransformerLM.load(args.model, device=args.device)
    criterion = TimeDistributedCriterion(ClassNLLCriterion(), True)
    results = LocalValidator(model, ds).test([Loss(criterion)])
    for method, result in results:
        print(f"{method} is {result}")
        # exp(mean loss), from the same accumulation
        print(f"Perplexity is {PerplexityResult(result.loss, result.count)}")

    words = None
    if args.generate:
        tokens = text.SentenceTokenizer().transform_one(args.prompt)
        if not tokens:
            raise SystemExit(f"--prompt {args.prompt!r} tokenizes to "
                             f"nothing; provide at least one word")
        ids = [[dictionary.get_index(t) + 1 for t in tokens]]
        out = generate(model, model.params, ids, args.generate,
                       temperature=args.temperature, rng=0,
                       device=args.device)
        words = [dictionary.get_word(int(i) - 1) for i in out[0]]
        print("generated:", " ".join(words))
    return results, words


if __name__ == "__main__":
    main()
