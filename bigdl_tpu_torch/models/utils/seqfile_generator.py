"""ImageNet record-shard generator CLI (port of
``bigdl_tpu/models/utils/seqfile_generator.py``; ref
models/utils/ImageNetSeqFileGenerator.scala + the writer
dataset/image/BGRImgToLocalSeqFile.scala): convert an image-folder
layout ``<folder>/<split>/<class>/<img>`` into packed record shards,
one file list a split, for sharded loading.

    python -m bigdl_tpu_torch.models.utils.seqfile_generator \\
        -f /imagenet -o /shards -p 64 --splits train val

Each record is an image file's bytes as they are (PNG, JPEG), with its
1-based label by sorted class directory; shard ``i`` of a split holds
records ``i, i + n, ...``.  The shards are byte for byte the JAX
package's for the same tree.
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert <folder>/<split>/<class>/<img> into record "
                    "shards")
    p.add_argument("-f", "--folder", required=True, help="image root dir")
    p.add_argument("-o", "--output", required=True, help="shard output dir")
    p.add_argument("-p", "--parallel", type=int, default=16,
                   help="shards per split")
    p.add_argument("--splits", nargs="*", default=["train", "val"])
    p.add_argument("--validate", action="store_true",
                   help="re-read shards after writing and verify counts")
    return p


def _scan_split(split_dir: str) -> list[tuple[str, float]]:
    """(path, 1-based label) for every file, labels by sorted class dir
    (the same rule as ``DataSet.image_folder``)."""
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    records = []
    for li, cls in enumerate(classes, start=1):
        d = os.path.join(split_dir, cls)
        for fname in sorted(os.listdir(d)):
            records.append((os.path.join(d, fname), float(li)))
    return records


def generate(folder: str, output: str, parallel: int,
             splits: list[str], validate: bool = False) -> dict[str, int]:
    """Write each split's shards on the host pool; returns the record
    count of each split.  ``validate`` reads every shard back and
    raises ``RuntimeError`` when a count differs."""
    from bigdl_tpu_torch.dataset.seqfile import read_shard, write_shard
    from bigdl_tpu_torch.dataset.types import ByteRecord
    from bigdl_tpu_torch.utils.engine import Engine

    os.makedirs(output, exist_ok=True)
    counts = {}
    for split in splits:
        split_dir = os.path.join(folder, split)
        if not os.path.isdir(split_dir):
            raise SystemExit(f"missing split dir {split_dir}")
        records = _scan_split(split_dir)
        counts[split] = len(records)
        n_shards = max(1, min(parallel, len(records)))

        def write_one(shard_idx: int) -> int:
            # round-robin assignment: shard i takes records i, i+n, ...
            def shard_records():
                for j in range(shard_idx, len(records), n_shards):
                    path, label = records[j]
                    with open(path, "rb") as f:
                        yield ByteRecord(f.read(), label)

            out_path = os.path.join(output, f"{split}-{shard_idx:05d}")
            return write_shard(out_path, shard_records())

        written = Engine.default_or_create().invoke_and_wait(
            [lambda i=i: write_one(i) for i in range(n_shards)])
        if sum(written) != len(records):
            raise RuntimeError(f"{split}: wrote {sum(written)} of "
                               f"{len(records)} records")
        if validate:
            total = sum(
                sum(1 for _ in read_shard(
                    os.path.join(output, f"{split}-{i:05d}")))
                for i in range(n_shards))
            if total != len(records):
                raise RuntimeError(f"{split}: wrote {len(records)} but "
                                   f"re-read {total}")
        print(f"{split}: {len(records)} records -> {n_shards} shards")
    return counts


def main(argv=None) -> dict[str, int]:
    args = build_parser().parse_args(argv)
    return generate(args.folder, args.output, args.parallel, args.splits,
                    args.validate)


if __name__ == "__main__":
    main()
