"""Prepare the frozen language stack for training or reward scoring with langweight > 0;
the port of ``r3m_tpu/prepare_language.py``.

Converts an HF ``DistilBertModel`` (``distilbert-base-uncased``, the reference's language
encoder, models_language.py:19-20, or a local ``save_pretrained`` directory) into the two
artifacts both packages read:

    python -m r3m_tpu_torch.prepare_language --out /path/to/lang
    # -> /path/to/lang/distilbert.npz (JAX-format pytree, bert_config metadata)
    #    /path/to/lang/vocab.txt

Needs `transformers` (imported in `prepare`) and the model in its cache or on disk. It runs
on the host and touches no device: a machine without `transformers` takes the two files
from one that has it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def prepare(model_name: str, out_dir: str) -> None:
    """Write ``distilbert.npz`` and ``vocab.txt`` for `model_name` into `out_dir`."""
    from transformers import AutoModel, AutoTokenizer

    from r3m_tpu_torch.checkpoint import save_snapshot
    from r3m_tpu_torch.convert import distilbert_tree
    from r3m_tpu_torch.models.distilbert import distilbert_config_from_state

    os.makedirs(out_dir, exist_ok=True)
    model = AutoModel.from_pretrained(model_name)
    sd = model.state_dict()
    # n_heads is not in the shapes: the HF config gives it, and the metadata keeps the
    # whole architecture for `load_bert`
    cfg = distilbert_config_from_state(sd, n_heads=int(getattr(model.config, "n_heads", 12)))
    npz = os.path.join(out_dir, "distilbert.npz")
    save_snapshot(npz, distilbert_tree(sd),
                  {"model": model_name, "bert_config": dataclasses.asdict(cfg)})

    tok = AutoTokenizer.from_pretrained(model_name)
    vocab_path = os.path.join(out_dir, "vocab.txt")
    vocab = sorted(tok.get_vocab().items(), key=lambda kv: kv[1])
    with open(vocab_path, "w") as f:
        f.write("\n".join(t for t, _ in vocab) + "\n")
    print(f"wrote {npz} and {vocab_path}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m r3m_tpu_torch.prepare_language",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="distilbert-base-uncased")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    prepare(args.model, args.out)


if __name__ == "__main__":
    main()
