from .gcg_pipeline import (GCGAnnotationPipeline, LLMBackend, StubLLM,
                           STEP1_PROMPT, STEP2_PROMPT, STEP3_PROMPT,
                           parse_dense_caption, build_instruction_record)
