"""Recurrent language-model evaluation CLI (port of
``bigdl_tpu/models/rnn/test.py``, ref models/rnn/Test.scala: load a
trained model and report the per-timestep loss and its perplexity on
held-out text), plus ``--device``.

    python -m bigdl_tpu_torch.models.rnn.test --model ckpt/model.6 \
        --dictionary ckpt/dictionary.json --synthetic --device cpu
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None):
    """Evaluate; prints ``Loss is ...`` and ``Perplexity is ...`` and
    returns the (method, result) pairs."""
    p = argparse.ArgumentParser(description="Evaluate SimpleRNN LM")
    p.add_argument("--model", required=True, help="trained model file")
    p.add_argument("--dictionary", default=None,
                   help="dictionary.json saved by the train CLI; without "
                        "it a dictionary is rebuilt from the input text, "
                        "which only matches the model for the same corpus")
    p.add_argument("-f", "--folder", default=None, help="input text file")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--vocabSize", type=int, default=4000)
    p.add_argument("--seqLength", type=int, default=24)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, text
    from bigdl_tpu_torch.models.rnn.train import read_corpus
    from bigdl_tpu_torch.models.utils import lm_corpus, lm_sample_pipe
    from bigdl_tpu_torch.optim import LocalValidator, Loss, PerplexityResult

    loaded = (text.Dictionary.load(args.dictionary) if args.dictionary
              else None)
    token_lists, dictionary = lm_corpus(read_corpus(args), args.vocabSize,
                                        dictionary=loaded)
    ds = DataSet.array(token_lists) >> lm_sample_pipe(
        dictionary, args.seqLength, args.batchSize)
    model = nn.Module.load(args.model, device=args.device)
    criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), True)
    results = LocalValidator(model, ds).test([Loss(criterion)])
    for method, result in results:
        print(f"{method} is {result}")
        # perplexity = exp(mean loss), from the same accumulation
        print(f"Perplexity is {PerplexityResult(result.loss, result.count)}")
    return results


if __name__ == "__main__":
    main()
