"""Conversation templating, tokenization and label masking for the
multimodal LLM (the port's own copy of videoglamm_tpu/data/conversation.py;
pure Python and numpy).

- template registry: phi3_instruct is the wired-in path; llama3_1 and the
  vicuna v1 template serve the alternate bases;
- `<video>` / `<image>` move to the front of the first user turn;
- `tokenizer_image_token` splits the prompt on `<image>` and puts an
  IMAGE_TOKEN_INDEX placeholder between the tokenized chunks;
- per-template label masking (the Phi-3 rounds split on `<|end|>`).

`<video>` maps to ONE placeholder: the splicer (models/multimodal.py)
inserts the whole [context ; video] prefix there.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..constants import (DEFAULT_IMAGE_TOKEN, DEFAULT_IM_END_TOKEN,
                         DEFAULT_IM_START_TOKEN, DEFAULT_VIDEO_TOKEN,
                         DEFAULT_VID_END_TOKEN, DEFAULT_VID_START_TOKEN,
                         IGNORE_INDEX, IMAGE_TOKEN_INDEX)


class SeparatorStyle(enum.Enum):
    SINGLE = 1
    TWO = 2
    MPT = 3
    PLAIN = 4


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles,
                            [m[:] for m in self.messages],
                            self.sep_style, self.sep, self.sep2)

    def append_message(self, role: str, message: str):
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in self.messages:
                ret += role + (message + self.sep if message else "")
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in self.messages:
                ret += role + ": " + message + self.sep if message \
                    else role + ":"
            return ret
        raise ValueError(self.sep_style)


conv_templates: Dict[str, Conversation] = {
    # reference conversation.py:124-132
    "phi3_instruct": Conversation(
        system="<|system|>\nYou are a helpful AI assistant.",
        roles=("\n<|user|>\n", "\n<|assistant|>\n"),
        messages=[], sep_style=SeparatorStyle.MPT, sep="<|end|>"),
    # reference conversation.py:134-144
    "llama3_1": Conversation(
        system="A chat between a curious user and an artificial intelligence "
               "assistant. The assistant gives helpful, detailed, and polite "
               "answers to the user's questions.",
        roles=("USER", "ASSISTANT"),
        messages=[], sep_style=SeparatorStyle.TWO, sep=" ",
        sep2="<|end_of_text|>"),
    # reference conversation.py:111-121 (vicuna v1, llava path)
    "v1": Conversation(
        system="A chat between a curious user and an artificial intelligence "
               "assistant. The assistant gives helpful, detailed, and polite "
               "answers to the user's questions.",
        roles=("USER", "ASSISTANT"),
        messages=[], sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>"),
}


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """Tokenize with `<image>` chunks replaced by the placeholder id
    (reference mm_utils.py:17-37)."""
    chunks = [tokenizer(c).input_ids for c in
              prompt.split(DEFAULT_IMAGE_TOKEN)]

    ids: List[int] = []
    bos = getattr(tokenizer, "bos_token_id", None)
    offset = 0
    if chunks and chunks[0] and bos is not None and chunks[0][0] == bos:
        offset = 1
        ids.append(chunks[0][0])

    # interleave chunks (minus any leading bos on later chunks) with the
    # placeholder
    for i, chunk in enumerate(chunks):
        c = chunk[offset:] if (i == 0 or offset == 0) else chunk
        if i > 0:
            ids.append(image_token_index)
            if bos is not None and c and c[0] == bos:
                c = c[1:]
        ids.extend(c)
    return ids


class ConvGenerator:
    """Conversation builder + label masking (reference
    ConvGenerator_VideoGPTPlus, conv_generator.py:200-278)."""

    def __init__(self, base_type: str = "phi3",
                 use_mm_start_end: bool = False):
        self.base_type = base_type
        key = {"phi3": "phi3_instruct", "llama3_1": "llama3_1"}[base_type]
        self.default_conversation = conv_templates[key]
        self.use_mm_start_end = use_mm_start_end

    # ------------------------------------------------------------------
    def _preprocess_multimodal(self, source: List[dict]) -> List[dict]:
        out = []
        for sentence in source:
            value = sentence["value"]
            for tok in (DEFAULT_VIDEO_TOKEN, DEFAULT_IMAGE_TOKEN):
                if tok in value:
                    value = tok + "\n" + value.replace(tok, "").strip()
                    value = value.strip()
            im_rep = DEFAULT_IMAGE_TOKEN
            vid_rep = DEFAULT_IMAGE_TOKEN  # ONE placeholder (see module doc)
            if self.use_mm_start_end:
                im_rep = DEFAULT_IM_START_TOKEN + im_rep + DEFAULT_IM_END_TOKEN
                vid_rep = DEFAULT_VID_START_TOKEN + vid_rep \
                    + DEFAULT_VID_END_TOKEN
            value = value.replace(DEFAULT_VIDEO_TOKEN, "\0VID\0")
            value = value.replace(DEFAULT_IMAGE_TOKEN, im_rep)
            value = value.replace("\0VID\0", vid_rep)
            out.append({**sentence, "value": value})
        return out

    # ------------------------------------------------------------------
    def apply(self, source: List[dict]) -> List[str]:
        """source: [{'from': 'human'|'gpt', 'value': str}, ...] -> prompts."""
        conv = self.default_conversation.copy()
        source = self._preprocess_multimodal(source)
        roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], (role, j)
            conv.append_message(role, sentence["value"])
        return [conv.get_prompt()]

    def apply_for_chat(self, prompt_text: str, media: str = "video") -> str:
        """Build a chat prompt string ending with an open assistant turn
        (reference conv_generator.py:88-135)."""
        tok = DEFAULT_VIDEO_TOKEN if media == "video" else DEFAULT_IMAGE_TOKEN
        src = [{"from": "human", "value": tok + "\n" + prompt_text}]
        src = self._preprocess_multimodal(src)
        conv = self.default_conversation.copy()
        conv.messages = []
        conv.append_message(conv.roles[0], src[0]["value"])
        conv.append_message(conv.roles[1], "")
        return conv.get_prompt()

    # ------------------------------------------------------------------
    def tokenize_and_mask(self, conversation: str, tokenizer,
                          max_len: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Tokenize one full conversation and build CE labels with the
        instruction (system+user) spans masked to IGNORE_INDEX
        (reference preprocess_fn_phi3, conv_generator.py:231-278).

        Returns (input_ids [max_len], labels [max_len], valid_len)."""
        ids = tokenizer_image_token(conversation, tokenizer)
        ids = ids[:max_len]
        target = np.asarray(ids, np.int64).copy()

        if self.base_type == "phi3":
            self._mask_phi3(conversation, target, tokenizer)
        else:
            self._mask_llama(conversation, target, tokenizer)

        n = len(ids)
        out_ids = np.zeros(max_len, np.int64)
        out_lab = np.full(max_len, IGNORE_INDEX, np.int64)
        out_ids[:n] = ids
        out_lab[:n] = target[:n]
        return out_ids, out_lab, n

    def _tok_len(self, text: str, tokenizer) -> int:
        return len(tokenizer_image_token(text, tokenizer))

    def _mask_phi3(self, conversation: str, target: np.ndarray, tokenizer):
        conv = self.default_conversation
        sep = conv.sep + conv.roles[1]          # '<|end|>\n<|assistant|>\n'
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[idx:idx + 2]))
        cur = 0
        total = len(target)
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = self._tok_len(rou, tokenizer)
            instruction_len = self._tok_len(parts[0], tokenizer) - 1
            if i == 0:
                round_len += 1
                instruction_len += 1
            else:
                round_len -= 2
                instruction_len -= 2
            target[cur:min(cur + instruction_len, total)] = IGNORE_INDEX
            cur += round_len
        target[min(cur, total):] = IGNORE_INDEX

    def _mask_llama(self, conversation: str, target: np.ndarray, tokenizer):
        conv = self.default_conversation
        sep = conv.sep + conv.roles[1] + ":"
        rounds = conversation.split(conv.sep2)
        cur = 1
        total = len(target)
        target[:cur] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = self._tok_len(rou, tokenizer)
            instruction_len = self._tok_len(parts[0], tokenizer) - 1
            target[cur:min(cur + instruction_len, total)] = IGNORE_INDEX
            cur += round_len
        target[min(cur, total):] = IGNORE_INDEX
