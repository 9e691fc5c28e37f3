"""Prompt acquisition (counterpart of imagine360_tpu/pipeline/captioner.py):
the prompt `.txt` next to the video when there is one; else a caller's
captioner on frame 4; else an LMM captioner (transformers, Qwen-VL-Chat
style `chat`) loaded from a local directory, used once and freed; else the
default prompt. Nothing is fetched: the LMM loads only from a directory that
exists, and any failure there gives the default prompt.
"""
from __future__ import annotations

import gc
import os
from typing import Callable, Optional

import numpy as np

CAPTION_INSTRUCTION = ("Describe the foreground and possible background of "
                       "this image in one sentence.")
CAPTION_FRAME = 4       # the reference captions this frame


class PromptProvider:
    def __init__(self, default_prompt: str = "",
                 captioner: Optional[Callable[[np.ndarray], str]] = None,
                 lmm_path: Optional[str] = None):
        self.default_prompt = default_prompt
        self.captioner = captioner
        self.lmm_path = lmm_path

    def _lmm_caption(self, frame_u8: np.ndarray) -> Optional[str]:
        """The LMM's caption of one frame, or None without a local model
        directory or on any failure."""
        if not self.lmm_path or not os.path.isdir(self.lmm_path):
            return None
        try:
            import tempfile

            import imageio
            from transformers import AutoModelForCausalLM, AutoTokenizer

            tok = AutoTokenizer.from_pretrained(self.lmm_path, trust_remote_code=True,
                                                local_files_only=True)
            model = AutoModelForCausalLM.from_pretrained(
                self.lmm_path, trust_remote_code=True, local_files_only=True).eval()
            with tempfile.NamedTemporaryFile(suffix=".png") as f:
                imageio.imwrite(f.name, frame_u8)
                query = tok.from_list_format([{"image": f.name},
                                              {"text": CAPTION_INSTRUCTION}])
                response, _ = model.chat(tok, query=query, history=None)
            del model
            gc.collect()
            return response
        except Exception:
            return None

    def __call__(self, video_path: str, frames_u8: np.ndarray) -> str:
        sidecar = os.path.splitext(video_path)[0] + ".txt"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                return f.read().strip()
        frame = frames_u8[min(CAPTION_FRAME, len(frames_u8) - 1)]
        if self.captioner is not None:
            return self.captioner(frame)
        caption = self._lmm_caption(frame)
        return caption if caption else self.default_prompt
