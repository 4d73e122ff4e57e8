"""LLM orchestration with a JSON prompt cache (port of
dream2real_tpu/lang/llm.py).

The four task prompts (movable-object choice, distractor filtering with the
index-1 swap, multi-view caption aggregation, instruction -> goal and
normalising captions) are the texts of ``prompts.json``; ``cache.json`` maps
exact prompt strings to completions. Both files are byte-for-byte copies of
the JAX package's, so a cache made by either package replays in the other.
The cache is written through even when reading it is off. Backend: any
callable ``backend(prompt, temperature) -> completion``; the default is
``openai_backend``, whose import raises where the openai package is absent,
so a cache miss without a backend fails loudly.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Optional

with open(os.path.join(os.path.dirname(__file__), "prompts.json")) as _f:
    _PROMPTS = json.load(_f)


def openai_backend(model: str = "gpt-4"):
    """The reference's backend (gpt-4, temperature as asked, three tries)."""
    import openai

    def call(prompt: str, temperature: float) -> str:
        tries = 3
        while True:
            try:
                response = openai.ChatCompletion.create(
                    model=model,
                    messages=[{"content": prompt, "role": "user"}],
                    temperature=temperature,
                    max_tokens=200,
                )
                return response["choices"][0]["message"]["content"]
            except Exception:
                tries -= 1
                if tries == 0:
                    raise
                time.sleep(0.5)

    return call


class LangModel:
    """Writes to the cache even if read_cache is False; that flag only gates
    reading it."""

    def __init__(
        self,
        read_cache: bool = True,
        cache_path: str = "",
        backend: Optional[Callable[[str, float], str]] = None,
    ):
        self.check_cache = read_cache
        self.cache_path = cache_path
        self.cache: dict[str, str] = {}
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                self.cache = json.load(f)
        self.backend = backend

    def submit_prompt(self, prompt: str, temperature: float = 0.0, silent: bool = False) -> str:
        if self.cache_path and self.check_cache and prompt in self.cache:
            if not silent:
                print(f'Using response found in cache for prompt: "{prompt}"')
            return self.cache[prompt]

        max_len = 5000
        if len(prompt) > max_len:
            raise Exception(f"Prompt too long (length: {len(prompt)}). Max length is {max_len}.")
        backend = self.backend
        if backend is None:
            try:
                backend = openai_backend()
            except Exception as e:
                raise RuntimeError(
                    "LLM cache miss and no backend available. Provide a cache "
                    "file (use_cache_llm) or inject a backend callable. "
                    f"Prompt: {prompt[:120]!r}..."
                ) from e
        completion = backend(prompt, temperature)
        if self.cache_path:
            self.cache[prompt] = completion
            with open(self.cache_path, "w") as f:
                json.dump(self.cache, f, indent=4)
        if not silent:
            print(f'Returning response: "{completion}"')
        return completion

    def get_principal_noun(self, caption: str) -> str:
        prompt = _PROMPTS["principal_noun"].format(caption=caption)
        response = self.submit_prompt(prompt)
        return response.lower().replace(".", "")

    def get_movable_obj_idx(self, user_instr: str, obj_captions: list[str]) -> int:
        prompt = _PROMPTS["movable_obj"] + "\n"
        prompt += f'User instruction: "{user_instr}"\n'
        assert obj_captions[0] == "__background__"
        for i, caption in enumerate(obj_captions[1:]):  # skip the background
            prompt += f'Object {i + 1}: "{caption}"\n'
        response = self.submit_prompt(prompt)
        return int(re.findall(r"\d+", response)[0])

    def get_relevant_obj_idxs(self, scene_caption: str, obj_captions: list[str],
                              movable_obj_idx: int):
        prompt = _PROMPTS["relevant_objs"] + "\n"
        prompt += f'Scene caption: "{scene_caption}"\n'
        assert obj_captions[0] == "__background__"

        # Swap the movable object into index 1, so the LLM sees it first.
        obj_captions = obj_captions.copy()
        temp = obj_captions[1]
        obj_captions[1] = obj_captions[movable_obj_idx]
        obj_captions[movable_obj_idx] = temp

        for i, caption in enumerate(obj_captions[1:]):
            prompt += f'Object {i + 1}: "{caption}"\n'

        response = self.submit_prompt(prompt)
        decisions = response.split("\n")

        if decisions[-1] == "None":
            return list(range(1, len(obj_captions)))

        relevant_idxs = [movable_obj_idx]  # the movable object is always relevant
        for i, decision in enumerate(decisions):
            if i == 0:  # the movable object
                continue
            if "Yes" not in decision:
                # Undo the swap.
                relevant_idx = 1 if i + 1 == movable_obj_idx else i + 1
                relevant_idxs.append(relevant_idx)
        assert len(decisions) + 1 == len(obj_captions), (
            "Error: LLM returned wrong number of decisions for distractor status for objects"
        )
        return relevant_idxs

    def aggregate_captions_for_obj(self, captions, silent: bool = True) -> str:
        prompt = _PROMPTS["aggregate_captions"] + "\n"
        prompt += "List of captions:\n"
        for caption in captions:
            prompt += f'"{caption}"\n'
        return self.submit_prompt(prompt, silent=silent)

    def parse_instr(self, user_instr: str) -> tuple[str, str]:
        prompt = _PROMPTS["parse_instr"] + "\n"
        prompt += f'User instruction: "{user_instr}"\n'
        response = self.submit_prompt(prompt)
        goal_caption, norm_caption = response.split("\n")
        goal_caption = goal_caption.replace("Goal caption: ", "")
        norm_caption = norm_caption.replace("Normalising caption: ", "")
        return goal_caption, norm_caption
