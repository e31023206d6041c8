from .profiling import (DeviceRecordsLost, device_memory_report, profile_trace,
                        StepTimer, annotate)
