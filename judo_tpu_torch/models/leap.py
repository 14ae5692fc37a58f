"""Programmatic LEAP-hand + cube scene generator (mesh-free; the port's own copy
of ``judo_tpu/models/leap.py``, returning the MJCF as a string).

Builds the dexterous in-hand cube-rotation scene as an MJCF string from
compact data tables. The kinematic frames, inertias, joint ranges, and
actuator gains are the LEAP Hand robot's published parameters (the reference
uses the same hardware — judo/models/xml/leap_components/*); the collision
model here is intentionally different: every mesh is replaced by primitives
(phalanx/palm boxes + capsule fingertips) so the scene runs entirely on the
TPU-native primitive narrowphase, and hand self-collision is masked off via
contype/conaffinity (the planner's contact budget goes to hand-cube pairs).

Layout (matches the reference scene): cube freejoint body first (qpos[0:7]),
then the 16-joint hand (palm rotated palm-up), plus a mocap goal body.
"""

from __future__ import annotations

# --- joint classes: (range_lo, range_hi) — LEAP hand spec ---
JOINT_RANGES = {
    "mcp": (-0.314, 2.23),
    "rot": (-1.047, 1.047),
    "pip": (-0.506, 1.885),
    "dip": (-0.366, 2.042),
    "thumb_cmc": (-0.349, 2.094),
    "thumb_axl": (-0.349, 2.094),
    "thumb_mcp": (-0.47, 2.443),
    "thumb_ipl": (-1.34, 1.88),
}

# finger link chain shared by index/middle/ring:
# (suffix, pos, quat, joint_class, inertial(pos, quat, mass, diaginertia))
_FINGER_CHAIN = [
    ("bs", None, "0.500003 0.5 0.5 -0.499997", "mcp",
     ("-0.022516 0.033882 0.016359", "0.388092 0.677951 -0.247713 0.573067", 0.044,
      "1.74972e-05 1.61504e-05 7.21342e-06")),
    ("px", "-0.0122 0.0381 0.0145", "0.500003 -0.5 -0.499997 0.5", "rot",
     ("0.0075 -0.0002 -0.011", "0 0.707107 0 0.707107", 0.032,
      "4.8853e-06 4.3733e-06 3.0933e-06")),
    ("md", "0.015 0.0143 -0.013", "0.500003 0.5 -0.5 0.499997", "pip",
     ("0.0054215 -0.029148 0.015", "0.687228 0.687228 0.166487 0.166487", 0.037,
      "8.28004e-06 8.1598e-06 5.39516e-06")),
    ("ds", "0 -0.0361 0.0002", None, "dip",
     ("-0.0008794 -0.027019 0.014594", "0.702905 0.710643 -0.0212937 -0.0214203", 0.016,
      "3.71863e-06 3.02396e-06 1.6518e-06")),
]

# base-link positions of the three fingers on the palm
_FINGER_BASES = {"if": "-0.007 0.023 -0.0187", "mf": "-0.0071 -0.0224 -0.0187", "rf": "-0.00709 -0.0678 -0.0187"}

# simplified collision primitives per finger link (cube-facing subset)
_FINGER_COLL = {
    "px": ['<geom name="{f}_px_coll" class="hand_box" type="box" size="0.017 0.013 0.011" pos="0.0075 -0.0002 -0.011"/>'],
    "md": ['<geom name="{f}_md_coll" class="hand_box" type="box" size="0.017 0.011 0.013" pos="0.0075 -0.035 0.015"/>'],
    "ds": [
        '<geom name="{f}_ds_coll" class="hand_box" type="box" size="0.01 0.009 0.015" pos="0 -0.012 0.015"/>',
        # capsule fingertip replacing the tip mesh
        '<geom name="{f}_tip" class="hand_tip" type="capsule" size="0.012 0.010" pos="0 -0.035 0.0147" zaxis="0 1 0"/>',
    ],
}

# thumb chain
_THUMB_CHAIN = [
    ("mp", "-0.0693 -0.0012 -0.0216", "0.707109 0 0.707105 0", "thumb_cmc",
     ("0.0075 -0.0002 -0.011", "0 0.707107 0 0.707107", 0.032, "4.8853e-06 4.3733e-06 3.0933e-06"),
     ['<geom name="th_mp_coll" class="hand_box" type="box" size="0.017 0.013 0.011" pos="-0.0075 -0.0002 -0.011"/>']),
    ("bs", "0 0.0143 -0.013", "0.500003 0.5 -0.5 0.499997", "thumb_axl",
     ("0 0 -0.0070806", "0.707107 0.707107 0 0", 0.003, "6.1932e-07 5.351e-07 2.1516e-07"),
     []),
    ("px", "0 0.0145 -0.017", "0.707109 -0.707105 0 0", "thumb_mcp",
     ("-0.0020593 0.015912 -0.013733", "0.698518 0.697382 -0.104933 0.121324", 0.038,
      "9.87104e-06 9.32653e-06 4.36203e-06"),
     ['<geom name="th_px_coll" class="hand_box" type="box" size="0.01 0.02 0.012" pos="0 0.0105 -0.014"/>']),
    ("ds", "0 0.0466 0.0002", "1.32679e-06 0 0 1", "thumb_ipl",
     ("0.00096191 -0.024203 -0.014419", "0.35287 0.311272 -0.632839 0.614904", 0.049,
      "2.08591e-05 2.0402e-05 4.71335e-06"),
     [
         '<geom name="th_ds_coll" class="hand_box" type="box" size="0.01 0.018 0.012" pos="0 -0.0085 -0.015"/>',
         '<geom name="th_tip" class="hand_tip" type="capsule" size="0.013 0.010" pos="0 -0.045 -0.015" zaxis="0 1 0"/>',
     ]),
]

_TIP_SITES = {"if": "0 -0.045 0.0144", "mf": "0 -0.045 0.0144", "rf": "0 -0.045 0.0144", "th": "0 -0.055 -0.015"}


def _finger_xml(f: str) -> str:
    """Nested body chain for one finger."""
    parts = []
    depth = 0
    for suffix, pos, quat, jclass, inert in _FINGER_CHAIN:
        pos_attr = _FINGER_BASES[f] if suffix == "bs" else pos
        quat_attr = f' quat="{quat}"' if quat else ""
        ipos, iquat, mass, diag = inert
        parts.append(
            f'<body name="{f}_{suffix}" pos="{pos_attr}"{quat_attr}>'
            f'<inertial pos="{ipos}" quat="{iquat}" mass="{mass}" diaginertia="{diag}"/>'
            f'<joint name="{f}_{_JOINT_NAMES[suffix]}" class="{jclass}"/>'
        )
        for g in _FINGER_COLL.get(suffix, []):
            parts.append(g.format(f=f))
        if suffix == "ds":
            parts.append(f'<site name="trace_{f}_tip" pos="{_TIP_SITES[f]}" size="0.01"/>')
        depth += 1
    parts.append("</body>" * depth)
    return "\n".join(parts)


_JOINT_NAMES = {"bs": "mcp", "px": "rot", "md": "pip", "ds": "dip"}
_THUMB_JOINT_NAMES = {"mp": "cmc", "bs": "axl", "px": "mcp", "ds": "ipl"}


def _thumb_xml() -> str:
    parts = []
    depth = 0
    for suffix, pos, quat, jclass, inert, colls in _THUMB_CHAIN:
        ipos, iquat, mass, diag = inert
        parts.append(
            f'<body name="th_{suffix}" pos="{pos}" quat="{quat}">'
            f'<inertial pos="{ipos}" quat="{iquat}" mass="{mass}" diaginertia="{diag}"/>'
            f'<joint name="th_{_THUMB_JOINT_NAMES[suffix]}" class="{jclass}"/>'
        )
        parts.extend(colls)
        if suffix == "ds":
            parts.append(f'<site name="trace_th_tip" pos="{_TIP_SITES["th"]}" size="0.01"/>')
        depth += 1
    parts.append("</body>" * depth)
    return "\n".join(parts)


def _actuators_and_sensors() -> str:
    acts, sensors = [], []
    for f in ("if", "mf", "rf"):
        for suffix in ("bs", "px", "md", "ds"):
            j = f"{f}_{_JOINT_NAMES[suffix]}"
            jclass = _FINGER_CHAIN[["bs", "px", "md", "ds"].index(suffix)][3]
            acts.append(f'<position name="{j}_act" joint="{j}" class="{jclass}"/>')
            sensors.append(f'<jointpos name="{j}_sensor" joint="{j}"/>')
    for suffix, _, _, jclass, _, _ in _THUMB_CHAIN:
        j = f"th_{_THUMB_JOINT_NAMES[suffix]}"
        acts.append(f'<position name="{j}_act" joint="{j}" class="{jclass}"/>')
        sensors.append(f'<jointpos name="{j}_sensor" joint="{j}"/>')
    for f in ("cube", "if_tip", "mf_tip", "rf_tip", "th_tip"):
        sensors.append(f'<framepos name="trace_{f}" objtype="site" objname="trace_{f}"/>')
    return "<actuator>\n" + "\n".join(acts) + "\n</actuator>\n<sensor>\n" + "\n".join(sensors) + "\n</sensor>"


def _default_classes() -> str:
    cls = []
    for name, (lo, hi) in JOINT_RANGES.items():
        cls.append(
            f'<default class="{name}">'
            f'<joint pos="0 0 0" axis="0 0 -1" limited="true" range="{lo} {hi}"/>'
            f'<position ctrlrange="{lo} {hi}"/>'
            "</default>"
        )
    return "\n".join(cls)


def build_leap_cube_xml(
    hand_quat: str = "0 0.9961947 0 -0.0871557",
    hand_pos: str = "0 0 0",
    cube_pos: str = "0.0 0.0 0.2",
    goal_pos: str = "-0.1 -0.1 0.3",
    timestep: str = "0.01",
) -> str:
    """Full scene MJCF. Contact masks: cube contype=1/conaff=2, hand
    contype=2/conaff=1 — hand-cube pairs collide, hand-hand does not.

    hand_quat/cube_pos parameterize the palm-up / palm-down / side-mount
    scene variants (reference: leap_cube.xml / leap_cube_palm_down.xml /
    caltech_leap_cube.xml top-level layouts)."""
    return f"""
<mujoco model="leap_cube_tpu">
  <compiler angle="radian"/>
  <option timestep="{timestep}" integrator="implicitfast" cone="elliptic" impratio="100"/>

  <default>
    <geom solimp="0.99 0.999 0.01 0.001 1" solref="0.001 1" friction=".2"/>
    <position kp="0.3" kv="0.1"/>
    <joint damping="0.03"/>
    <default class="hand_box">
      <geom contype="2" conaffinity="1"/>
    </default>
    <default class="hand_tip">
      <geom contype="2" conaffinity="1" friction="0.7 0.05 0.0002"/>
    </default>
    <default class="cube_coll">
      <geom contype="1" conaffinity="2" friction="0.3 0.05 0.01"/>
    </default>
    <default class="visual">
      <geom contype="0" conaffinity="0" density="0"/>
    </default>
    {_default_classes()}
  </default>

  <worldbody>
    <body name="goal" pos="{goal_pos}" quat="1 0 0 0" mocap="true">
      <geom name="goal_vis" type="box" size="0.03 0.03 0.03" class="visual" rgba="0.4 0.8 0.4 0.5"/>
    </body>

    <body name="cube" pos="{cube_pos}" quat="1 0 0 0">
      <freejoint/>
      <geom name="cube" class="cube_coll" type="box" size="0.03 0.03 0.03" mass="0.108"/>
      <site name="trace_cube" pos="0 0 0" size="0.01"/>
    </body>

    <body name="leap_hand" pos="{hand_pos}" quat="{hand_quat}">
      <body name="palm" pos="0 0 0">
        <inertial pos="-0.049542 -0.042914 -0.010227" quat="0.565586 0.427629 -0.574956 0.408254"
                  mass="0.237" diaginertia="0.000407345 0.000304759 0.000180736"/>
        <geom name="palm_coll_a" class="hand_box" type="box" size="0.012 0.058 0.023" pos="-0.048 -0.033 -0.0115"/>
        <geom name="palm_coll_b" class="hand_box" type="box" size="0.01 0.06 0.015" pos="-0.03 -0.035 -0.003"/>
        <geom name="palm_coll_c" class="hand_box" type="box" size="0.022 0.026 0.023" pos="-0.078 -0.053 -0.0115"/>
        {_finger_xml("if")}
        {_finger_xml("mf")}
        {_finger_xml("rf")}
        {_thumb_xml()}
      </body>
    </body>
  </worldbody>

  {_actuators_and_sensors()}
</mujoco>
"""


_VARIANTS = {
    # palm-up (default): hand flipped so the palm faces up
    "leap_cube": {},
    # palm-down: hand in its natural orientation, cube held underneath
    "leap_cube_down": {
        "hand_quat": "1 0 0 0",
        "cube_pos": "-0.04 -0.035 -0.065",
        "goal_pos": "0.0 -0.2 -0.05",
    },
    # caltech mount: palm-up variant with a laterally offset cube rest pose
    "caltech_leap_cube": {
        "hand_quat": "0 0.9961947 0 -0.0871557",
        "cube_pos": "0.11 0.005 0.04",
        "goal_pos": "-0.1 -0.1 0.3",
    },
    # higher-fidelity SIMULATION variant: the plant integrates at 5x the
    # planner rate (0.002 vs 0.01), matching the reference's fidelity split
    # (judo/tasks/leap_cube.py:14-15, leap_components/params_and_default_sim.xml)
    "leap_cube_sim": {"timestep": "0.002"},
}


def leap_cube_xml(variant: str = "leap_cube") -> str:
    """The generated scene MJCF of a variant, as a string."""
    return build_leap_cube_xml(**_VARIANTS[variant])
