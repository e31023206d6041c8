from .profiling import (device_memory_report, profile_trace, StepTimer,
                        annotate)
