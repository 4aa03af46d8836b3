"""Incidents (the port of brpc_tpu/incident/): capture on anomaly and
bounded artifacts.

The watchdog (``bvar/anomaly.py``) finds the break; the recorder
(``traffic/capture.py``) records; this package joins them. An opening
incident puts the recorder in corpus-recording mode for a bounded
window, then bundles the window's requests and the snapshots that
explain it (/status, the trigger keys' /timeline, /hotspots, /device,
/backends, /serving, the annotated rpcz spans) into one size-capped
``.brpcinc`` artifact under a disk budget. Replaying an artifact
(``replay.py``) waits for the chaos and replay tools (ROADMAP
section 1).
"""

from brpc_tpu_torch.incident.artifact import (SUFFIX, ArtifactWriter,
                                              artifact_files,
                                              artifact_summary,
                                              read_artifact)
from brpc_tpu_torch.incident.manager import (IncidentManager,
                                             attach_incident_server,
                                             bind_incident_imports,
                                             expose_incident_vars,
                                             global_manager,
                                             incident_sample_tick,
                                             incident_status_line,
                                             incidents_snapshot_payload)

__all__ = [
    "ArtifactWriter", "SUFFIX", "artifact_files", "artifact_summary",
    "read_artifact", "IncidentManager", "attach_incident_server",
    "bind_incident_imports", "expose_incident_vars", "global_manager",
    "incident_sample_tick", "incident_status_line",
    "incidents_snapshot_payload",
]
