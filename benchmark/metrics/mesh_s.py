"""mesh_s: seconds per request in the program's mesher
(``mesh/mesher.mesh_problem``), the harness's own span around it; only
where every request meshes its own geometry."""


def read(run):
    t = [r.mesh_seconds for r in run.requests
         if r.error is None and r.mesh_seconds is not None]
    return sum(t) / len(t) if t else None
