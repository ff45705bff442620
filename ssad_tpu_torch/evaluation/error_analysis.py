"""Classification-error analysis: misclassified samples with their class
probabilities.

Counterpart of ssad_tpu/evaluation/error_analysis.py:20-86 (reference
ErrorAnalyzer, tools.py:150-200): the samples whose good-vs-defect
decision disagrees with the truth, drawn side by side, each under its
per-class softmax probabilities and its true and predicted labels.  The
JAX package draws the panel with matplotlib, the port with PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ssad_tpu_torch.constants import PRETEXT_CLASSES, ModelOutputs

_TILE, _TEXT_H, _GAP = 160, 84, 8


def softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


class ErrorAnalyzer:
    def __init__(self, outputs: ModelOutputs):
        host = outputs.to_host()
        self.probabilities = softmax(np.asarray(host.raw_predictions, np.float64))
        self.y_hat_multiclass = np.argmax(self.probabilities, axis=1)
        self.true_binary = np.asarray(host.y_true_binary)
        self.images = host.original_data

    @property
    def wrong_indices(self) -> np.ndarray:
        """Samples whose binary decision disagrees with the truth
        (tools.py:167-169)."""
        pred_binary = (self.y_hat_multiclass > 0).astype(int)
        return np.nonzero(pred_binary != self.true_binary)[0]

    def analyze(self, num_images: int = 10, randomized: bool = True,
                output_path: str = "probabilities.png", seed: int = 0) -> Optional[str]:
        """Draw up to ``num_images`` misclassified samples (a seeded numpy
        choice, as the JAX package's) → the PNG's path, or None when
        nothing was misclassified."""
        from PIL import Image, ImageDraw

        wrong = self.wrong_indices
        if wrong.size == 0:
            return None
        if randomized:
            picks = np.random.default_rng(seed).choice(
                wrong, size=min(num_images, wrong.size), replace=False)
        else:
            picks = wrong[:num_images]
        canvas = Image.new("RGB", (len(picks) * (_TILE + _GAP), _TEXT_H + _TILE), "white")
        draw = ImageDraw.Draw(canvas)
        for col, idx in enumerate(picks):
            left = col * (_TILE + _GAP)
            probs = self.probabilities[idx]
            lines = [f"{PRETEXT_CLASSES[j]}: {probs[j]:.3f}" for j in range(len(probs))]
            true_lbl = "GOOD" if self.true_binary[idx] == 0 else "DEFECT"
            pred_lbl = "GOOD" if self.y_hat_multiclass[idx] == 0 else "DEFECT"
            lines += [f"true: {true_lbl}", f"pred: {pred_lbl}"]
            draw.multiline_text((left + 2, 2), "\n".join(lines), fill="black", spacing=1)
            if self.images is not None:
                u8 = (np.clip(self.images[idx], 0, 1) * 255).astype(np.uint8)
                canvas.paste(Image.fromarray(u8).resize((_TILE, _TILE)), (left, _TEXT_H))
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        canvas.save(out)
        return str(out)
