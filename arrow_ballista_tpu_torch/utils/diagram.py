"""GraphViz plan / execution-graph diagrams.

Counterpart of the reference's ``produce_diagram``
(``core/src/utils.rs:109-224``), which renders a job's query-stage DAG as
dot: one cluster per stage, one node per operator, edges child→parent
inside a stage and shuffle edges between stages.  Render with
``dot -Tsvg``.
"""

from __future__ import annotations

from typing import Optional


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def _label(op) -> str:
    text = str(op)
    return text if len(text) <= 80 else text[:77] + "..."


def produce_plan_diagram(plan, title: str = "plan") -> str:
    """Dot text for a single (logical or physical) operator tree."""
    lines = [
        "digraph G {",
        f'  label = "{_esc(title)}";',
        "  node [shape=box, fontname=monospace, fontsize=10];",
    ]
    counter = [0]

    def walk(op) -> int:
        my_id = counter[0]
        counter[0] += 1
        lines.append(f'  n{my_id} [label="{_esc(_label(op))}"];')
        for child in op.children():
            cid = walk(child)
            lines.append(f"  n{cid} -> n{my_id};")
        return my_id

    walk(plan)
    lines.append("}")
    return "\n".join(lines)


def produce_diagram(graph, title: Optional[str] = None) -> str:
    """Dot text for a job's ExecutionGraph: one subgraph cluster per stage
    (labelled with its state), operator nodes inside, and shuffle edges
    from each stage's root to the stages that consume its output
    (``output_links``) — the shape of ``core/src/utils.rs:109-224``."""
    from ..shuffle.execution_plans import ShuffleReaderExec, UnresolvedShuffleExec

    lines = [
        "digraph G {",
        f'  label = "{_esc(title or f"job {graph.job_id}")}";',
        "  compound = true;",
        "  node [shape=box, fontname=monospace, fontsize=10];",
    ]
    counter = [0]
    stage_root: dict[int, int] = {}  # stage id → root node id
    stage_readers: dict[int, list[tuple[int, int]]] = {}  # producer → [(node, consumer)]

    for sid in sorted(graph.stages):
        stage = graph.stages[sid]
        state = type(stage).__name__.replace("Stage", "")
        lines.append(f"  subgraph cluster_{sid} {{")
        lines.append(f'    label = "Stage {sid} [{state}]";')

        def walk(op) -> int:
            my_id = counter[0]
            counter[0] += 1
            lines.append(f'    n{my_id} [label="{_esc(_label(op))}"];')
            if isinstance(op, (ShuffleReaderExec, UnresolvedShuffleExec)):
                producer = getattr(op, "stage_id", None)
                if producer is not None:
                    stage_readers.setdefault(producer, []).append((my_id, sid))
            for child in op.children():
                cid = walk(child)
                lines.append(f"    n{cid} -> n{my_id};")
            return my_id

        stage_root[sid] = walk(stage.plan)
        lines.append("  }")

    # shuffle edges: producer stage root → consumer stage's reader node
    for producer, readers in stage_readers.items():
        if producer in stage_root:
            for node, _consumer in readers:
                lines.append(
                    f"  n{stage_root[producer]} -> n{node} [style=dashed];"
                )
    # fall back to output_links for stages whose consumers hold resolved
    # readers without stage ids
    for sid in sorted(graph.stages):
        stage = graph.stages[sid]
        for link in getattr(stage, "output_links", []) or []:
            if link in stage_root and sid not in stage_readers:
                lines.append(
                    f"  n{stage_root[sid]} -> n{stage_root[link]}"
                    " [style=dashed, color=gray];"
                )
    lines.append("}")
    return "\n".join(lines)


def save_diagram(graph, path: str, title: Optional[str] = None) -> None:
    with open(path, "w") as f:
        f.write(produce_diagram(graph, title))
