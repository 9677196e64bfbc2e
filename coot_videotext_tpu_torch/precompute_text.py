"""
Offline text-feature extraction with a pretrained language model (port of
precompute_text.py at the repo root, reference precompute_text.py:44-452):

    python -m coot_videotext_tpu_torch.precompute_text <dataset_name> \\
        [--data_path data] [--model_name bert-base-uncased] \\
        [--layers -2,-1] [--token_stride] [--device cpu] \\
        [--output_format h5|npy] [-f] [-t]

reads <data_path>/<dataset_name>/meta_<metadata_name>.json, feeds each
paragraph flat through the HF AutoModel (cross-sentence context; the text
preprocessor chosen per model family), and writes the concatenated hidden
states of `--layers` (1536-d for BERT base) as
text_feat_<dataset>_meta_<metadata>_<model ident>.h5, or as the `npy` text
source (a directory of `<key>.npy`, data/features_loader.py) where h5py is
not installed, beside <ident>_sentence_splits.json. Paragraphs longer than
the model's positions are cut back to front (each sentence keeps at least
`min_cut` tokens and its last one) or, with `--token_stride`, run in
strided windows whose overlap is dropped. The features go to a temporary
name first and are moved into place when complete. The model runs on the
CUDA device unless `--device cpu` is given; asked for CUDA without a GPU
it raises. `transformers` and the model's weights must be installed or
cached locally.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from copy import deepcopy
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from coot_videotext_tpu_torch.data.synthetic import default_feat_format
from coot_videotext_tpu_torch.data.text import (
    TextPreprocessing, get_text_preprocessor)
from coot_videotext_tpu_torch.utils import arguments
from coot_videotext_tpu_torch.utils.arguments import ArgParser
from coot_videotext_tpu_torch.utils.general import get_timestamp_for_filename


class TextConverterDataset:
    """Paragraph -> flat token sequence dataset (reference :315)."""

    def __init__(self, tokenizer, text_dict: Dict[str, List[str]],
                 preprocessor, *, max_text_len: int = 512,
                 min_cut: int = 5, token_stride: bool = False,
                 add_special_tokens: bool = False) -> None:
        self.tokenizer = tokenizer
        self.text_dict = text_dict
        self.preprocessor = preprocessor
        self.max_text_len = max_text_len
        self.min_cut = min_cut
        self.token_stride = token_stride
        self.add_special_tokens = add_special_tokens
        self.keys = list(text_dict.keys())

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, item: int):
        key = self.keys[item]
        processed_text = self.preprocessor(self.text_dict[key])
        par_tokens: List[List[int]] = []
        for sentence in processed_text:
            tok_str = self.tokenizer.tokenize(
                sentence, add_special_tokens=self.add_special_tokens)
            par_tokens.append(self.tokenizer.convert_tokens_to_ids(tok_str))

        total = sum(len(s) for s in par_tokens)
        if total > self.max_text_len and not self.token_stride:
            # cut sentences back to front, each keeps >= min_cut tokens and
            # its last one (reference :379-409)
            original = [len(s) for s in par_tokens]
            new_lengths = deepcopy(original)
            for sent in reversed(range(len(new_lengths))):
                overshoot = sum(new_lengths) - 512
                if overshoot <= 0:
                    break
                new_lengths[sent] = max(self.min_cut,
                                        len(par_tokens[sent]) - overshoot)
            par_tokens = [
                tokens if old_len == new_len
                else tokens[:new_len - 1] + [tokens[-1]]
                for tokens, old_len, new_len in zip(par_tokens, original,
                                                    new_lengths)]
            print(f"\nKey: {key}, Cut input {sum(original)} to "
                  f"{self.max_text_len}, new length: "
                  f"{sum(len(s) for s in par_tokens)}")

        return {"key": key,
                "tokens": np.asarray([w for s in par_tokens for w in s],
                                     np.int64),
                "sentence_lengths": [len(s) for s in par_tokens]}

    def collate_fn(self, batch):
        """Pad tokens and build masks (reference :418)."""
        lengths = [len(b["tokens"]) for b in batch]
        tokens = np.zeros((len(batch), max(lengths)), np.int64)
        mask = np.zeros((len(batch), max(lengths)), bool)
        for i, b in enumerate(batch):
            tokens[i, :lengths[i]] = b["tokens"]
            mask[i, :lengths[i]] = True
        return {"key": [b["key"] for b in batch], "tokens": tokens,
                "mask": mask, "lengths": lengths,
                "sentence_lengths": [b["sentence_lengths"] for b in batch]}


def preprocessor_for(model_name: str, set_tokenizer: str = ""):
    """The text preprocessor of a model family (reference :118-140)."""
    if set_tokenizer != "":
        return get_text_preprocessor(set_tokenizer)
    if model_name == "bert-base-uncased":
        return get_text_preprocessor(TextPreprocessing.BERT_PAPER)
    if model_name.startswith(("bert", "distilbert")):
        return get_text_preprocessor(TextPreprocessing.BERT_NEW)
    if model_name.startswith("gpt2"):
        return get_text_preprocessor(TextPreprocessing.GPT2)
    print(f"WARNING: no text preprocessing defined for model {model_name}, "
          "using simple preprocessing.")
    return get_text_preprocessor(TextPreprocessing.SIMPLE)


def layer_features(model, tokens, mask, layers: List[int],
                   max_text_len: int, stride_factor: int) -> np.ndarray:
    """The concatenated hidden states of `layers` for a padded batch on
    the model's device, in strided windows past `max_text_len` tokens
    (reference :213-241): (B, L, D x len(layers)) float32."""
    import torch
    total_len = tokens.shape[1]
    if total_len <= max_text_len:
        out = model(input_ids=tokens, attention_mask=mask,
                    output_hidden_states=True)
        return torch.cat([out["hidden_states"][n] for n in layers],
                         dim=-1).float().cpu().numpy()
    stride = max_text_len // stride_factor
    positions = list(range(0, total_len - stride, stride))
    print(f"Length {total_len}! Split with window {max_text_len} stride "
          f"{stride} into {len(positions)} windows")
    outs = []
    for pos in positions:
        o = model(input_ids=tokens[:, pos:pos + max_text_len],
                  attention_mask=mask[:, pos:pos + max_text_len],
                  output_hidden_states=True)
        feats = [o["hidden_states"][n] for n in layers]
        if pos != 0:
            feats = [f[:, stride:] for f in feats]
        outs.append(torch.cat(feats, dim=-1).float().cpu().numpy())
    return np.concatenate(outs, axis=1)


class _Writer:
    """The features of each key into a temporary h5 file or directory of
    `<key>.npy`, moved over `final` by `commit`."""

    def __init__(self, final: Path, fmt: str) -> None:
        self.final, self.fmt = final, fmt
        self.temp = final.parent / \
            f"TEMP_{get_timestamp_for_filename()}_{final.name}"
        if fmt == "h5":
            import h5py
            self.h5 = h5py.File(self.temp, "w")
        else:
            self.temp.mkdir(parents=True)

    def __setitem__(self, key: str, value: np.ndarray) -> None:
        if self.fmt == "h5":
            self.h5[key] = value
        else:
            np.save(self.temp / f"{key}.npy", value)

    def commit(self) -> None:
        if self.fmt == "h5":
            self.h5.close()
        print(f"Wrote data to {self.temp}, moving to {self.final}")
        if self.final.is_dir():
            shutil.rmtree(self.final)
        elif self.final.is_file():
            os.remove(self.final)
            time.sleep(0.1)
        shutil.move(str(self.temp), str(self.final))


def build_parser() -> ArgParser:
    parser = ArgParser(description=__doc__)
    parser.add_argument("dataset_name", type=str, help="dataset name")
    arguments.add_dataset_path_arg(parser)
    parser.add_argument("-t", "--test", action="store_true",
                        help="test only")
    parser.add_argument("--metadata_name", type=str, default="all")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--cuda", action="store_true",
                        help="(compat) the model runs on --device")
    parser.add_argument("--multi_gpu", action="store_true",
                        help="(compat) no effect")
    parser.add_argument("--model_path", type=str, default=None,
                        help="Cache path for transformers package.")
    parser.add_argument("--model_name", type=str,
                        default="bert-base-uncased")
    parser.add_argument("--model_source", type=str, default="transformers")
    parser.add_argument("--layers", type=str, default="-2,-1")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--workers", type=int, default=0)
    parser.add_argument("--add_name", type=str, default="")
    parser.add_argument("-f", "--force", action="store_true")
    parser.add_argument("--set_tokenizer", type=str, default="",
                        help=f"Manually define the preprocessor. Options: "
                             f"{TextPreprocessing.values()}")
    parser.add_argument("--add_special_tokens", action="store_true")
    parser.add_argument("--token_stride", action="store_true")
    parser.add_argument("--token_stride_factor", type=int, default=2)
    parser.add_argument("--output_format", choices=("h5", "npy"),
                        default=None,
                        help="h5 (default where h5py is installed) or the "
                             "npy text source")
    return parser


def main(argv: Optional[List[str]] = None) -> Optional[Path]:
    """Run the tool; returns the features' path (None when they exist
    and -f is not given, or with --test)."""
    args = build_parser().parse_args(argv)
    from coot_videotext_tpu_torch.train_retrieval import resolve_device
    device = resolve_device(args.device)
    fmt = args.output_format or default_feat_format()
    data_path = arguments.update_path_from_args(args)
    dataset_path = Path(data_path) / args.dataset_name
    model_name = args.model_name
    model_ident = (f"{args.model_source}_"
                   f"{model_name.replace('/', '--')}_{args.layers}")
    full_ident = (f"text_feat_{args.dataset_name}_meta_"
                  f"{args.metadata_name}_{model_ident}{args.add_name}")
    os.makedirs(dataset_path, exist_ok=True)
    lengths_file = dataset_path / f"{full_ident}_sentence_splits.json"
    data_file = dataset_path / (f"{full_ident}.h5" if fmt == "h5"
                                else full_ident)
    if data_file.exists() and lengths_file.exists() and not args.force:
        print(f"{data_file} already exists. nothing to do.")
        return None

    import torch
    from transformers import AutoModel, AutoTokenizer
    assert args.model_source == "transformers", (
        f"Model source unknown: {args.model_source}")
    tokenizer = AutoTokenizer.from_pretrained(model_name,
                                              cache_dir=args.model_path)
    model = AutoModel.from_pretrained(model_name, cache_dir=args.model_path)
    max_text_len = model.config.max_position_embeddings
    model = model.to(device)
    model.eval()
    preprocessor = preprocessor_for(model_name, args.set_tokenizer)
    layers = [int(la.strip()) for la in args.layers.strip().split(",")]

    meta_file = dataset_path / f"meta_{args.metadata_name}.json"
    meta_dict = json.loads(meta_file.read_text(encoding="utf8"))
    text_dict = {key: [seg["text"] for seg in meta["segments"]]
                 for key, meta in meta_dict.items()}
    dataset = TextConverterDataset(
        tokenizer, text_dict, preprocessor, max_text_len=max_text_len,
        token_stride=args.token_stride,
        add_special_tokens=args.add_special_tokens)
    if args.test:
        for key, value in dataset[0].items():
            print(f"{key}: {value}\n")
        print("Test, stopping here.")
        return None

    writer = _Writer(data_file, fmt)
    lengths = {}
    total_feat_dim = None
    bs = args.batch_size
    with torch.no_grad():
        for start in range(0, len(dataset), bs):
            batch = dataset.collate_fn(
                [dataset[i] for i in
                 range(start, min(start + bs, len(dataset)))])
            features = layer_features(
                model, torch.from_numpy(batch["tokens"]).to(device),
                torch.from_numpy(batch["mask"]).to(device), layers,
                max_text_len, args.token_stride_factor)
            total_feat_dim = features.shape[-1]
            for i, key in enumerate(batch["key"]):
                feature = features[i, :batch["lengths"][i]]
                sentence_lengths = batch["sentence_lengths"][i]
                if feature.shape[0] != sum(sentence_lengths):
                    print(f"WARNING: feature len {feature.shape[0]} != sum "
                          f"sentence lengths {sum(sentence_lengths)} for "
                          f"{key}")
                writer[key] = feature
                lengths[key] = sentence_lengths
    writer.commit()
    lengths_file.write_text(json.dumps(lengths), encoding="utf8")
    print(f"Wrote sentence splits to {lengths_file}")
    print(f"Total feature dim of {len(layers)} layers is {total_feat_dim}")
    return data_file


if __name__ == "__main__":
    main()
