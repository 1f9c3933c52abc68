"""Field schema for KV decoding — configuration, not constants.

The reference hard-codes a Japanese bank-transfer schema of 17 classes
(NUL + 8 key/value pairs) and derives field names by stripping the 'k_'/'v_'
prefix (inference/postprocess.py:2-15).  Here the schema is a dataclass so
any document type can plug in its own class list.

Host copy of ``msau_tpu.infer.schema`` (that package's ``__init__`` imports JAX);
tests/test_torch_host_copies.py pins it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

# Default schema mirroring the reference deployment (postprocess.py:2-5).
DEFAULT_CLASS_NAMES: Tuple[str, ...] = (
    "NUL",
    "k_bank_name", "v_bank_name",
    "k_bank_branch_name", "v_bank_branch_name",
    "k_account_number", "v_account_number",
    "k_account_type", "v_account_type",
    "k_account_name", "v_account_name",
    "k_account_name_kana", "v_account_name_kana",
    "k_branch", "v_branch",
    "k_financial_institution", "v_financial_institution",
)


@dataclass(frozen=True)
class FieldSchema:
    class_names: Tuple[str, ...] = DEFAULT_CLASS_NAMES
    # classes whose values may span several text lines (kv_model.py:155)
    multiple_lines_fields: Tuple[int, ...] = (5, 11)
    non_count_overlap_fields: Tuple[int, ...] = ()
    contain_one_line_fields: Tuple[int, ...] = ()
    # When True, FieldValue.boxes carries every qualifying component box of
    # a multi-line field (each then counts toward num_pred in the field
    # eval); False replays the committed reference, which keeps only the
    # main component (kv_model.py:255 ``list_boxes = [boxes_for_field[c][-1]]``
    # with the all-boxes variant left commented out).
    all_component_boxes: bool = False

    @property
    def n_class(self) -> int:
        return len(self.class_names)

    def value_classes(self) -> Tuple[int, ...]:
        """Class ids whose name carries the 'v_' value prefix."""
        return tuple(
            i for i, n in enumerate(self.class_names) if n.startswith("v_")
        )

    def field_name(self, class_id: int) -> str:
        if class_id < len(self.class_names):
            return self.class_names[class_id][2:]
        return str(class_id)


def post_process_kv(
    values: Sequence,
    schema: FieldSchema = FieldSchema(),
    reference_compat: bool = False,
) -> Dict[str, str]:
    """Map per-class extracted values to {field_name: text}.

    Default: every 'v_*' class contributes {name-without-prefix: text} —
    the evident intent of the reference schema.

    ``reference_compat=True`` replays the literal reference arithmetic
    (postprocess.py:8-15): odd classes > 1 emit
    {CLASS_NAMES[idx-1][2:]: values[idx]}, which pairs each text with the
    *preceding* class's stripped name (an off-by-one against the committed
    CLASS_NAMES ordering, kept available for byte-level compat).
    """
    results = {}
    if reference_compat:
        for idx, v in enumerate(values):
            if idx % 2 == 1 and idx > 1:
                name = (
                    schema.class_names[idx - 1][2:]
                    if len(schema.class_names) > idx - 1
                    else str(idx - 1)
                )
                results[name] = v[0]
        return results
    for idx in schema.value_classes():
        if idx < len(values) and idx > 1:
            results[schema.field_name(idx)] = values[idx][0]
    return results
