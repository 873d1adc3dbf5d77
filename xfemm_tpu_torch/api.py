"""High-level session API: the femmcli automation surface, pythonic.

The reference drives everything through ~250 Lua commands per domain
(cfemm/femmcli/LuaMagneticsCommands.cpp mi_*/mo_*, ei_*/eo_*, hi_*/ho_*)
around a FemmState session (cfemm/femmcli/FemmState.h:79). This module is
the functional equivalent: a Document wraps a Problem with geometry
editing, property management, meshing, in-process solving, and a
Solution handle exposing the postprocessor. Names are idiomatic Python;
the mapping to the Lua verbs is 1:1 in semantics (mi_addnode ->
doc.add_node, mi_analyze -> doc.analyze, mo_getpointvalues ->
sol.point_values, mo_blockintegral -> sol.block_integral, ...).

Example::

    import xfemm_tpu_torch.api as femm
    doc = femm.new_document("magnetics")
    doc.problem.LengthUnits = femm.LengthUnit.CENTIMETERS
    n = [doc.add_node(x, y) for x, y in corners]
    doc.add_segment(n[0], n[1], boundary="A0")
    doc.add_material("Air")            # from the built-in defaults
    doc.add_block_label(1, 1, material="Air")
    sol = doc.analyze()
    print(sol.point_values(1.0, 1.0))
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .constants import FileType, LengthUnit, ProblemType
from .geometry import editor, femfile
from .geometry.problem import (ArcSegment, BlockLabel, BoundaryProp, Circuit,
                               Conductor, ElectrostaticsMaterial,
                               HeatMaterial, Node, PointProp, Problem,
                               Segment)
from .materials import library
from .materials.magnetic import MagneticMaterial

_DOCTYPES = {
    "magnetics": FileType.MAGNETICS,
    "heatflow": FileType.HEATFLOW,
    "electrostatics": FileType.ELECTROSTATICS,
}


def new_document(doctype: str = "magnetics", device=None,
                 hbm_bytes: float | None = None) -> "Document":
    """mi_newdocument / femm's newdocument(doctype)."""
    p = Problem(filetype=_DOCTYPES[doctype])
    return Document(p, device=device, hbm_bytes=hbm_bytes)


def open_document(path: str, device=None,
                  hbm_bytes: float | None = None) -> "Document":
    """femm's open(): load a .fem/.feh/.fee problem."""
    return Document(femfile.load(path), path=path, device=device,
                    hbm_bytes=hbm_bytes)


class Document:
    """A problem in session. ``device`` runs its solves (and the
    postprocessor's mask solve): CUDA when None, an error without a
    card; ``"cpu"`` runs the kernels' plain PyTorch versions and needs
    ``hbm_bytes``, the device memory the band planner plans against
    (read from the card on CUDA)."""

    def __init__(self, problem: Problem, path: str | None = None,
                 device=None, hbm_bytes: float | None = None):
        self.problem = problem
        self.path = path
        self.device = device
        self.hbm_bytes = hbm_bytes
        self._mesh = None

    # ---------------- geometry (mi_addnode & co.) --------------------- #
    def add_node(self, x: float, y: float) -> int:
        return editor.add_node(self.problem, x, y)

    def add_segment(self, n0, n1, boundary: str | None = None,
                    group: int = 0, conductor: str | None = None) -> None:
        props = {"InGroup": group}
        if boundary is not None:
            props["BoundaryMarker"] = self.problem.boundary_index(boundary)
        if conductor is not None:
            props["InConductor"] = self._conductor_index(conductor)
        n0 = n0 if isinstance(n0, int) else self.add_node(*n0)
        n1 = n1 if isinstance(n1, int) else self.add_node(*n1)
        editor.add_segment(self.problem, n0, n1, **props)

    def add_arc(self, n0, n1, angle: float, max_seg_deg: float = 1.0,
                boundary: str | None = None, group: int = 0,
                conductor: str | None = None) -> None:
        props = {"InGroup": group}
        if boundary is not None:
            props["BoundaryMarker"] = self.problem.boundary_index(boundary)
        if conductor is not None:
            props["InConductor"] = self._conductor_index(conductor)
        n0 = n0 if isinstance(n0, int) else self.add_node(*n0)
        n1 = n1 if isinstance(n1, int) else self.add_node(*n1)
        editor.add_arc_segment(self.problem, n0, n1, angle, max_seg_deg,
                               **props)

    def add_block_label(self, x: float, y: float,
                        material: str | None = None, circuit: str = "",
                        magdir=0.0, group: int = 0, turns: int = 1,
                        mesh_size: float = 0.0) -> int:
        lab = BlockLabel(x=x, y=y, InGroup=group, Turns=turns)
        if material is not None:
            lab.BlockType = self.problem.material_index(material)
        if circuit:
            lab.InCircuit = self.problem.circuit_index(circuit)
        if isinstance(magdir, str):
            lab.MagDirFctn = magdir
        else:
            lab.MagDir = float(magdir)
        lab.MaxArea = (np.pi * mesh_size * mesh_size / 4.0
                       if mesh_size > 0 else 0.0)
        self.problem.labellist.append(lab)
        return len(self.problem.labellist) - 1

    # --------------- properties (mi_addmaterial & co.) ---------------- #
    def add_material(self, mat, **kw):
        """Accepts a material object, a name from the bundled defaults,
        or keyword fields (mi_addmaterial)."""
        if isinstance(mat, str):
            obj = _default_material(self.problem.filetype, mat, **kw)
        else:
            obj = mat
        self.problem.blockproplist.append(obj)
        return obj

    def add_material_from_library(self, path: str, name: str):
        """mi_getmaterial equivalent against an explicit library file;
        records are parsed for this document's problem domain."""
        mats = library.load(path, filetype=self.problem.filetype)
        self.problem.blockproplist.append(mats[name])
        return mats[name]

    def add_boundary(self, name: str, **kw) -> BoundaryProp:
        bp = BoundaryProp(name=name, **kw)
        self.problem.lineproplist.append(bp)
        return bp

    def add_circuit(self, name: str, amps=0.0, circuit_type: int = 1):
        c = Circuit(name=name, Amps=complex(amps), CircType=circuit_type)
        self.problem.circproplist.append(c)
        return c

    def add_conductor(self, name: str, V: float = 0.0, q: float = 0.0,
                      conductor_type: int = 1):
        c = Conductor(name=name, V=V, q=q, CircType=conductor_type)
        self.problem.circproplist.append(c)
        return c

    def add_point_prop(self, name: str, **kw) -> PointProp:
        pp = PointProp(name=name, **kw)
        self.problem.nodeproplist.append(pp)
        return pp

    def set_node_prop(self, x: float, y: float, prop: str | None = None,
                      group: int = 0, conductor: str | None = None):
        """mi_setnodeprop on the node nearest (x, y)."""
        i = self._nearest_node(x, y)
        nd = self.problem.nodelist[i]
        nd.InGroup = group
        if prop is not None:
            nd.BoundaryMarker = self.problem.point_prop_index(prop)
        if conductor is not None:
            nd.InConductor = self._conductor_index(conductor)

    # ------------------- transforms (mi_move*/mi_copy*) --------------- #
    def move_translate(self, dx: float, dy: float, group=None, **sel):
        editor.transform_selection(self.problem, "translate",
                                   complex(dx, dy), group=group, **sel)
        self._mesh = None

    def move_rotate(self, cx: float, cy: float, deg: float, group=None,
                    **sel):
        editor.transform_selection(self.problem, "rotate",
                                   (complex(cx, cy), deg), group=group,
                                   **sel)
        self._mesh = None

    def copy_translate(self, dx: float, dy: float, copies: int = 1,
                       group=None, **sel):
        editor.transform_selection(self.problem, "translate",
                                   complex(dx, dy), group=group,
                                   copies=copies, **sel)

    def copy_rotate(self, cx: float, cy: float, deg: float,
                    copies: int = 1, group=None, **sel):
        editor.transform_selection(self.problem, "rotate",
                                   (complex(cx, cy), deg), group=group,
                                   copies=copies, **sel)

    def mirror(self, x0, y0, x1, y1, group=None, copies: int = 1, **sel):
        editor.transform_selection(self.problem, "mirror",
                                   (complex(x0, y0), complex(x1, y1)),
                                   group=group, copies=copies, **sel)

    def scale(self, cx, cy, factor, group=None, **sel):
        editor.transform_selection(self.problem, "scale",
                                   (complex(cx, cy), factor), group=group,
                                   **sel)
        self._mesh = None

    # --------------------------- pipeline ----------------------------- #
    def save(self, path: str) -> None:
        femfile.dump(self.problem, path)
        self.path = path

    def create_mesh(self):
        """mi_createmesh: triangulate and keep the mesh in-session.

        With ``XFEMM_TPU_PREMESHED=1`` and a complete set of mesh files
        (``<doc path>.node/.ele/.edge/.pbc``) next to the document, the
        premeshed files are loaded instead of re-triangulating -- the
        reference's own premeshed-fixture strategy (its fsolver consumes
        exactly these files, and its solver test suite checks them in:
        cfemm/fsolver/test/CMakeLists.txt:15-27).  Opt-in because
        femmcli itself always re-meshes."""
        import os
        from .mesh import mesher, meshdata
        if self.path and os.environ.get("XFEMM_TPU_PREMESHED"):
            base = os.path.splitext(self.path)[0]
            if all(os.path.exists(base + ext)
                   for ext in (".node", ".ele", ".edge", ".pbc")):
                self._mesh = meshdata.read_mesh_files(base)
                return self._mesh
        self._mesh = mesher.mesh_problem(self.problem)
        return self._mesh

    def analyze(self) -> "Solution":
        """mi_analyze + mi_loadsolution in one step (in-memory)."""
        from . import models
        if self._mesh is None:
            self.create_mesh()
        sol = models.solve(self.problem, self._mesh, device=self.device,
                           hbm_bytes=self.hbm_bytes)
        return Solution(self, self._mesh, sol)

    def _nearest_node(self, x, y) -> int:
        pts = np.array([[n.x, n.y] for n in self.problem.nodelist])
        return int(np.argmin(((pts - [x, y]) ** 2).sum(axis=1)))

    def _conductor_index(self, name: str) -> int:
        for i, c in enumerate(self.problem.circproplist):
            if c.name == name:
                return i
        raise KeyError(name)


class Solution:
    """Postprocessor handle (the mo_*/ho_*/eo_* surface)."""

    def __init__(self, doc: Document, mesh, sol):
        self.doc = doc
        self.mesh = mesh
        self.raw = sol
        ft = doc.problem.filetype
        if ft == FileType.MAGNETICS:
            from .post.fpproc import MagPostProcessor
            self.post = MagPostProcessor(doc.problem, mesh, sol.A,
                                         sol.label_case, device=doc.device)
        elif ft == FileType.HEATFLOW:
            from .post.scalarproc import HeatPostProcessor
            nbc = getattr(sol, "node_Q", None)
            self.post = HeatPostProcessor(
                doc.problem, mesh, sol.T,
                node_bc=(nbc != -2) if nbc is not None else None)
        else:
            from .post.scalarproc import ElecPostProcessor
            nbc = getattr(sol, "node_Q", None)
            self.post = ElecPostProcessor(
                doc.problem, mesh, sol.V,
                node_bc=(nbc != -2) if nbc is not None else None)

    # ------------------------------------------------------------------ #
    def point_values(self, x: float, y: float) -> dict:
        return self.post.get_point_values(x, y)

    def block_integral(self, inttype: int, labels=None):
        if labels is None:
            labels = set(range(len(self.post.labels)))
        return self.post.block_integral(inttype, labels)

    def line_integral(self, inttype: int, contour):
        return self.post.line_integral(inttype, contour)

    def gap_integral(self, bdry_name: str, inttype: int):
        return self.post.gap_integral(bdry_name, inttype)

    def select_blocks_at(self, *points) -> set:
        """Label indices of the blocks containing the given points
        (mo_selectblock)."""
        out = set()
        for x, y in points:
            t = self.post.find_element(x, y)
            if t >= 0:
                out.add(int(self.mesh.element_labels[t]))
        return out

    def circuit_properties(self, name: str):
        """mo_getcircuitproperties: (current, voltage drop, flux linkage)
        for magnetics circuits."""
        return self.post.circuit_properties(name)

    def save(self, path: str) -> None:
        """Write the solution file (.ans/.anh/.res by problem type)."""
        from .io import ansfile
        p = self.doc.problem
        if p.filetype == FileType.MAGNETICS:
            sf = ansfile.SolutionFile(
                problem=p,
                mesh=ansfile.solution_mesh_from_solver(self.mesh, 1.0),
                values=self.raw.A, label_case=self.raw.label_case,
                values_prev=getattr(self.raw, "Aprev", None))
            ansfile.write_ans(sf, path)
        elif p.filetype == FileType.HEATFLOW:
            ansfile.write_scalar_solution(
                p, self.mesh, self.raw.T, self.raw.node_Q,
                list(zip(self.raw.conductor_V, self.raw.conductor_q)),
                path)
        else:
            ansfile.write_scalar_solution(
                p, self.mesh, self.raw.V, self.raw.node_Q,
                list(zip(self.raw.conductor_V, self.raw.conductor_q)),
                path)


def _default_material(ftype: FileType, name: str, **kw):
    if ftype == FileType.MAGNETICS:
        if name.lower() == "air":
            return MagneticMaterial(name=name)
        return MagneticMaterial(name=name, **kw)
    if ftype == FileType.HEATFLOW:
        return HeatMaterial(name=name, **kw)
    return ElectrostaticsMaterial(name=name, **kw)
