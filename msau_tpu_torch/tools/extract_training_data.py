"""CLI: VIA-style labeling-tool JSON → per-image label JSONs + charset.

Equivalent of scripts/extract_training_data.py: parses VIA region
annotations (rect or polygon), normalizes digits to '0', maps
``formal_key``/``type`` attributes to (type_idx, value_idx) pairs with the
k_/v_ class naming, exports {'img_shape','lines':[...]} label files and a
top-300 charset.  Host copy of ``msau_tpu.tools.extract_training_data``:
the same files from the same labels.

Usage:
  python -m msau_tpu_torch.tools.extract_training_data --label_dir labels \
      --image_dir images --save_dir out --classes bank_name account_number
"""

import argparse
import codecs
import json
import os
from collections import Counter
from typing import Dict, List, Optional, Tuple

from msau_tpu_torch.data.pages import Line, save_label_json
from msau_tpu_torch.utils.io import glob_folder

TYPE_IDX = {
    "other": 0, "key": 1, "value": 2,
    "common_key": 0, "master": 0, "master_key": 0,
}


class DataExtractor:
    def __init__(self, output_dir: str, class_list: List[str], top_chars: int = 300):
        self.output_dir = output_dir
        self.class_list = class_list
        self.top_chars = top_chars
        self.key_set: List[str] = []
        self.all_chars: List[str] = []
        self.class_names = ["nul"] * (2 * len(class_list))
        for i, key in enumerate(class_list):
            self.class_names[2 * i] = "k_" + key
            self.class_names[2 * i + 1] = "v_" + key
        os.makedirs(output_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def parse_region(self, rg: dict) -> Optional[Tuple[List[int], str, int, int]]:
        shape = rg.get("shape_attributes", {})
        attrs = rg.get("region_attributes", {})
        try:
            if shape.get("name") == "polygon":
                xs, ys = shape["all_points_x"], shape["all_points_y"]
                box = [min(xs), min(ys), max(xs), max(ys)]
            else:
                x, y, w, h = shape["x"], shape["y"], shape["width"], shape["height"]
                box = [x, y, x + w, y + h]
        except KeyError:
            return None
        text = attrs.get("label", "")
        text = "".join("0" if c.isdigit() else c for c in text)
        rtype = attrs.get("type", "").replace(" ", "_")
        key = (
            attrs.get("formal_key", "")
            .replace(" ", "")
            .replace("\n", "")
            .replace("　", "")
            .replace("__", "_")
        )
        if key not in self.class_list:
            key, rtype = "", "other"
        if rtype in ("key", "value") and key:
            if key not in self.key_set:
                self.key_set.append(key)
            kidx = self.key_set.index(key)
            value_idx = 2 * kidx + 1 if rtype == "key" else 2 * kidx + 2
        else:
            value_idx = 0
        type_idx = TYPE_IDX.get(rtype, 0)
        # frequency-boost charset chars of labeled fields (reference :178-181)
        self.all_chars += list(text) * (10 if value_idx > 0 else 1)
        return box, text, type_idx, value_idx

    def process(self, label_dir: str, image_dir: Optional[str] = None) -> int:
        label_map = glob_folder(label_dir, "json")
        image_map = glob_folder(image_dir, "jpg") if image_dir else None
        n_ok = 0
        for name, path in sorted(label_map.items()):
            if image_map is not None and name not in image_map:
                continue
            with codecs.open(path, "r", "utf-8-sig") as f:
                content = json.load(f)
            if "_via_img_metadata" in content:
                content = content["_via_img_metadata"]
            data = content[list(content.keys())[0]]
            lines = []
            for rg in data.get("regions", []):
                parsed = self.parse_region(rg)
                if parsed is None:
                    continue
                box, text, type_idx, value_idx = parsed
                lines.append(Line(box=tuple(box), text=text, label=type_idx, value=value_idx))
            img_shape = [data.get("height", 0), data.get("width", 0)]
            out = os.path.join(self.output_dir, name + ".json")
            # writer matching scripts/data_util.py:33-39
            doc = {
                "img_shape": img_shape,
                "lines": [
                    {"box": list(l.box), "text": l.text, "type": l.label, "value": l.value}
                    for l in lines
                ],
            }
            with open(out, "w", encoding="utf-8") as f:
                json.dump(doc, f, ensure_ascii=False)
            n_ok += 1
        self.export_charset()
        return n_ok

    def export_charset(self):
        counts = Counter(self.all_chars)
        counts.pop(" ", None)
        charset = sorted(c for c, _ in counts.most_common(self.top_chars))
        with open(os.path.join(self.output_dir, "charset.txt"), "w", encoding="utf-8") as f:
            f.write("".join(charset))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--label_dir", required=True)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--classes", nargs="+", required=True)
    args = p.parse_args(argv)
    ex = DataExtractor(args.save_dir, args.classes)
    n = ex.process(args.label_dir, args.image_dir)
    print(f"exported {n} label files; classes: {ex.class_names}")


if __name__ == "__main__":
    main()
