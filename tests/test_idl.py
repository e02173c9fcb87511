"""ROS 2 interface schemas (`boundplanner_tpu/idl/`) + typed MPCData path.

Closes the last ROS parity sliver: the schemas of
the reference interface package (`boundmpcmsg/msg/MPCData.msg`,
`msg/Vector.msg`, `srv/Trajectory.srv`, `srv/MPCParams.srv`) ship with the
engine, a parser makes them load-bearing, and `ros_compat.to_mpc_data_msg`
fills the generated message classes when the colcon-built package is
importable (tested with injected fakes, like the rclpy tests)."""

import dataclasses

import numpy as np
import pytest

from boundplanner_tpu import idl
from boundplanner_tpu import ros_compat as rc


def test_mpcdata_schema_loads_with_reference_fields():
    schema = idl.load_msg("MPCData")
    # spot the contract: reference field set, exact names and kinds
    assert schema["t_comp"] == idl.Field("float32", False, "t_comp")
    assert schema["iterations"].type == "int32"
    assert schema["fails"] == idl.Field("float32", True, "fails")
    assert schema["q"] == idl.Field("Vector", True, "q")
    assert schema["phi"] == idl.Field("Vector", False, "phi")
    assert schema["sector"].type == "int32"
    for f in ("e_p", "e_r_orth1", "p_ref", "bp1", "br2",
              "a_set_j3", "b_set_elbow", "a_set_next"):
        assert f in schema, f
    assert len(schema) == 60  # header + 59 payload fields, ref-exact


def test_vector_and_srv_schemas_load():
    vec = idl.load_msg("Vector")
    assert vec["x"] == idl.Field("float64", True, "x")

    req, resp = idl.load_srv("Trajectory")
    for f in ("p_via", "r_via", "bp1", "br1", "a_set", "b_set",
              "obstacles", "p0", "q0", "update"):
        assert f in req, f
    assert resp["success"].type == "bool"

    req, resp = idl.load_srv("MPCParams")
    assert req["n"].type == "int16"
    assert req["weights"] == idl.Field("float32", True, "weights")
    assert resp["success"].type == "bool"


def test_validate_flags_unknown_field_and_kind_mismatch():
    schema = idl.load_msg("MPCData")
    idl.validate(schema, {"t_comp": 0.01, "fails": [0.0], "sector": 2})
    with pytest.raises(ValueError, match="not in schema"):
        idl.validate(schema, {"not_a_field": 1.0})
    with pytest.raises(ValueError, match="expected scalar"):
        idl.validate(schema, {"t_comp": [0.01]})
    with pytest.raises(ValueError, match="expected int"):
        idl.validate(schema, {"sector": 1.5})


@dataclasses.dataclass
class _FakeVector:
    x: list = dataclasses.field(default_factory=list)


class _FakeMPCData:
    """Attribute bag standing in for the rosidl-generated class."""

    def __init__(self):
        self._set = {}

    def __setattr__(self, k, v):
        if k != "_set":
            self._set[k] = v
        super().__setattr__(k, v)


def _record():
    from boundplanner_tpu.telemetry import MPCTickRecord

    return MPCTickRecord(
        t=0.1, t_comp=0.02, t_loop=0.03, t_overhead=0.01, cost=1.5,
        iterations=3, phi=0.25, dphi=0.4, phi_max=1.2, sector=1,
        success=True, viol=0.0, e_p=np.zeros(3), e_r=np.zeros(3),
        p_ref=np.zeros(6), p=np.zeros(6), q=np.zeros(7),
    )


def test_typed_mpc_data_matches_schema():
    """Every field the typed converter sets exists in the shipped schema
    with a compatible kind — the schema and the code cannot drift apart."""
    msgs = {"MPCData": _FakeMPCData, "Vector": _FakeVector}
    m = rc.to_mpc_data_msg(msgs, _record())
    schema = idl.load_msg("MPCData")
    payload = {
        k: (v.x if isinstance(v, _FakeVector) else
            [list(e.x) for e in v] if isinstance(v, list)
            and v and isinstance(v[0], _FakeVector) else v)
        for k, v in m._set.items()
    }
    # Vector scalars arrive as lists -> mark them as composites for validate
    idl.validate(schema, payload)
    assert m.t_comp == pytest.approx(0.02)
    assert m.iterations == 3
    assert m.fails == [0.0]
    assert m.phi.x == [pytest.approx(0.25)]
    assert len(m.q) == 1 and len(m.q[0].x) == 7


def test_publisher_uses_typed_path_with_injected_boundmpcmsg(monkeypatch):
    """With a fake colcon-generated boundmpcmsg importable, publish_tick
    publishes the typed MPCData alongside the JSON String."""
    import sys
    import types

    import tests.test_ros_compat as trc

    fake_msg = types.ModuleType("boundmpcmsg.msg")
    fake_msg.MPCData = _FakeMPCData
    fake_msg.Vector = _FakeVector
    fake_pkg = types.ModuleType("boundmpcmsg")
    fake_pkg.msg = fake_msg
    monkeypatch.setitem(sys.modules, "boundmpcmsg", fake_pkg)
    monkeypatch.setitem(sys.modules, "boundmpcmsg.msg", fake_msg)
    trc._install_fake_ros(monkeypatch)

    pub = rc.RosPublisher()
    assert pub.active and pub.typed is not None
    pub.publish_tick(_record())
    typed_pub = next(
        p for p in pub.node.pubs if p.topic.endswith("mpc_data_typed")
    )
    assert len(typed_pub.published) == 1
    assert isinstance(typed_pub.published[0], _FakeMPCData)
    json_pub = next(
        p for p in pub.node.pubs if p.topic.endswith("/mpc_data")
    )
    assert len(json_pub.published) == 1
    pub.shutdown()
