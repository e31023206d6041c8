"""Semi-automatic GCG annotation generation (the port's own copy of
videoglamm_tpu/datagen/gcg_pipeline.py).

Behavioral contract from the reference gcg_data_gen
(gcg_data_gen/burst_ytvis_gcg/README.md:1-21, generation.py): a 3-step LLM captioning flow over videos with instance
masks —
  step 1: rough per-object caption ("what does the <cls> look like / do");
  step 2: corrected per-object caption given the box-overlaid frames;
  step 3: dense video caption where each mentioned instance is tagged
          `{obj_<id>}` right after its noun;
then `{obj_}` tags are parsed into (caption, token_pos, mask_id) — the
GCGVideoDataset instruction schema (generate_annotations.py).

The LLM is a pluggable `LLMBackend`
(caption(prompt, images) -> str) — hosted Gemini/GPT backends plug in where
the reference hardcodes google.generativeai (generation.py:9); a
deterministic StubLLM keeps the pipeline testable offline.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Dict, List, Optional, Protocol, Sequence

STEP1_PROMPT = ("These are frames from a video that I want to upload. What "
                "does the {cls} look like and what is the {cls} doing?")
STEP2_PROMPT = ("These are frames from a video that I want to upload. "
                "Please modify this caption: {cap} The instance in the video "
                "is surrounded by a rectangular box with color number "
                "{obj_id}. The output caption must include what the {cls} "
                "looks like and what the {cls} is doing. Please do not "
                "mention any information about the bbox in the output.")
STEP3_PROMPT = ("These are frames from a video that I want to upload. In "
                "the video, the ID number of the box is on the top left of "
                "the box. There are some instance captions: '{caps}' "
                "Generate a dense caption that describes the video in "
                "detail based on the video and instance captions, including "
                "all of the instances mentioned in the instance captions "
                "and other instances in the video. Ensure that each "
                "instance mentioned in the instance caption appears exactly "
                "once in the dense caption, followed by the format "
                "{{obj_}} to indicate which instance caption the mentioned "
                "instance corresponds to. The {{obj_}} must directly follow "
                "the noun representing the instance. Please do not mention "
                "any information about the bbox in the output.")


class LLMBackend(Protocol):
    def caption(self, prompt: str, images: Sequence) -> str:
        ...


class StubLLM:
    """Deterministic offline backend for tests / dry runs."""

    def caption(self, prompt: str, images: Sequence) -> str:
        if "dense caption" in prompt:
            m = re.findall(r"'(.*?)'", prompt)
            caps = m[0].split(" | ") if m else []
            parts = [f"a thing {{obj_{i}}} appears"
                     for i in range(len(caps))]
            return "In the video " + " and ".join(parts) + "."
        return "an object moving through the scene"


def parse_dense_caption(caption: str) -> Dict:
    """`... noun {obj_3} ...` -> {"caption", "token_pos", "mask_id"}:
    token_pos indexes the WORD preceding each tag in the cleaned caption
    (the GCGVideoDataset contract, utils/video_gcg_dataset.py:90-114)."""
    words = caption.split()
    clean_words: List[str] = []
    token_pos: List[int] = []
    mask_ids: List[int] = []
    tag = re.compile(r"\{obj_(\d+)\}")
    for w in words:
        m = tag.fullmatch(w.strip(".,"))
        if m is not None:
            if clean_words:
                token_pos.append(len(clean_words) - 1)
                mask_ids.append(int(m.group(1)))
            continue
        # tag glued to the word: "dog{obj_0}" / "dog{obj_0},"
        m = tag.search(w)
        if m is not None:
            bare = tag.sub("", w)
            if bare:
                clean_words.append(bare)
            token_pos.append(len(clean_words) - 1)
            mask_ids.append(int(m.group(1)))
            continue
        clean_words.append(w)
    return {"caption": " ".join(clean_words), "token_pos": token_pos,
            "mask_id": mask_ids}


def build_instruction_record(video_meta: Dict, dense: Dict) -> Dict:
    """Assemble one `videos` entry of the GCG instruction JSON
    (generate_annotations.py output schema)."""
    return {
        "file_names": video_meta["file_names"],
        "width": video_meta["width"],
        "height": video_meta["height"],
        "length": video_meta["length"],
        "dense_cap": {
            "caption": dense["caption"],
            "token_pos": dense["token_pos"],
            "mask_id": dense["mask_id"],
            "v_id2o_id": video_meta.get("v_id2o_id", {}),
        },
    }


@dataclasses.dataclass
class GCGAnnotationPipeline:
    """3-step generation over a video collection with instance annotations."""
    llm: LLMBackend

    def step1(self, cls_name: str, frames: Sequence) -> str:
        return self.llm.caption(STEP1_PROMPT.format(cls=cls_name), frames)

    def step2(self, cls_name: str, rough_caption: str, obj_id: int,
              boxed_frames: Sequence) -> str:
        return self.llm.caption(
            STEP2_PROMPT.format(cap=rough_caption, obj_id=obj_id,
                                cls=cls_name), boxed_frames)

    def step3(self, instance_captions: Sequence[str],
              boxed_frames: Sequence) -> str:
        return self.llm.caption(
            STEP3_PROMPT.format(caps=" | ".join(instance_captions)),
            boxed_frames)

    def annotate_video(self, video_meta: Dict, objects: List[Dict],
                       frames: Sequence) -> Dict:
        """objects: [{"id", "cls"}]. Returns a GCG instruction `videos`
        entry (mask annotations ride along separately)."""
        corrected = []
        for i, obj in enumerate(objects):
            rough = self.step1(obj["cls"], frames)
            corrected.append(self.step2(obj["cls"], rough, i, frames))
        dense_text = self.step3(corrected, frames)
        dense = parse_dense_caption(dense_text)
        # remap local tag ids -> annotation mask ids
        dense["mask_id"] = [objects[i]["id"] for i in dense["mask_id"]
                            if i < len(objects)]
        return build_instruction_record(video_meta, dense)
