"""The Decathlon datalist (a copy of ``load_decathlon_datalist`` in
``medseg/data/dataset.py``): parse a ``dataset.json`` list of {"image",
"label"} entries (or bare image paths) into absolute paths."""

from __future__ import annotations

import json
import os


def load_decathlon_datalist(
    json_path: str,
    is_segmentation: bool = True,
    data_list_key: str = "training",
    base_dir: str | None = None,
) -> list[dict]:
    with open(json_path) as f:
        meta = json.load(f)
    if data_list_key not in meta:
        raise KeyError(f"{data_list_key!r} not found in {json_path}")
    base = base_dir if base_dir is not None else os.path.dirname(os.path.abspath(json_path))
    out = []
    for entry in meta[data_list_key]:
        if isinstance(entry, str):  # "test" lists may be bare image paths
            entry = {"image": entry}
        item = dict(entry)
        for key in ("image", "label"):
            if key in item and not os.path.isabs(item[key]):
                item[key] = os.path.join(base, item[key])
        out.append(item)
    return out
