"""Programmatic Spot quadruped (+arm) scene generator, mesh-free (the port's own
copy of ``judo_tpu/models/spot.py``, returning the MJCF as a string).

Generates the Spot robot MJCF from compact data tables: the four legs come
from one template with sign mirrors, the 7-DoF arm chain from a link table.
Kinematic frames, inertials, joint limits and actuator gains are the Spot
hardware's published parameters (the reference uses the same robot —
judo/models/xml/spot_primitive/*); all mesh visuals are dropped, keeping only
the primitive collision geometry, which is what both the TPU narrowphase and
the planner need.

Actuator order (legs FL,FR,HL,HR x (hx,hy,kn), then 7 arm joints) matches the
C++ rollout's ctrl layout (mujoco_extensions/system/system_class.cpp:246).
"""

from __future__ import annotations

# joint class -> (frictionloss, damping, armature, range, kp, kv, forcerange)
JOINT_CLASSES = {
    "hip_x": (0.5, 0.25, 0.0403155, (-0.785398, 0.785398), 60, 1.5, 45),
    "hip_y": (0.5, 0.25, 0.0403155, (-0.898845, 2.29511), 60, 1.5, 45),
    "knee": (0.5, 0.25, 0.073125, (-2.7929, -0.2471), 60, 1.5, 115),
    "arm_sh0": (0.5, 0.25, 0.17953760, (-2.61799387799149441136, 3.14159265358979311599), 120, 2.0, 90.9),
    "arm_sh1": (0.5, 0.25, 0.71815040, (-3.14159265358979311599, 0.52359877559829881565), 120, 2.0, 181.8),
    "arm_el0": (0.5, 0.25, 0.17953760, (0.0, 3.14159265358979311599), 120, 2.0, 90.9),
    "arm_el1": (0.5, 0.25, 0.05477937, (-2.79252680319092716487, 2.79252680319092716487), 120, 2.0, 30.3),
    "arm_wr0": (0.5, 0.25, 0.05477937, (-1.83259571459404613236, 1.83259571459404613236), 120, 2.0, 30.3),
    "arm_wr1": (0.5, 0.25, 0.07997584, (-2.87979326579064354163, 2.87979326579064354163), 120, 2.0, 30.3),
    "arm_f1x": (0.5, 0.25, 0.01717273, (-1.57, 0.0), 16.0, 0.32, 15.32),
}

# legs: (prefix, joint_prefix, sign_x, sign_y)
LEGS = [
    ("front_left", "fl", 1.0, 1.0),
    ("front_right", "fr", 1.0, -1.0),
    ("rear_left", "hl", -1.0, 1.0),
    ("rear_right", "hr", -1.0, -1.0),
]

# arm links: (name, pos, joint, axis, mass, inertial_pos, fullinertia, geoms)
ARM_LINKS = [
    ("arm_link_sh0", "0.292 0 0.188", "arm_sh0", "0 0 1", 1.904699,
     "-0.008399 0.000272 -0.024603", "0.008896 0.004922 0.0073030 0.000005 -0.000193 0.000033",
     ['<geom name="arm_link_sh0_base_collision" class="collision" type="capsule" size="0.05 0.015" pos="0 0 -0.07"/>',
      '<geom name="arm_link_sh0_motor_collision" class="collision" type="capsule" size="0.055 0.055" pos="-0.015 0 0" euler="1.57079632679 0 0"/>']),
    ("arm_link_sh1", "0 0 0", "arm_sh1", "0 1 0", 1.85701942,
     "0.08084909 -0.00167243 0.00045644", "0.00261526 0.02703868 0.02819929 -0.00040406 0.00010019 0.00000547",
     ['<geom name="arm_link_sh1_collision" class="collision" type="capsule" size="0.04 0.175" pos="0.17 0 0" euler="0 1.57079632679 0"/>']),
    ("arm_link_el0", "0.3385 0 0", "arm_el0", "0 1 0", 0.94831958,
     "0.04476621 -0.00271130 0.04991363", "0.00175909 0.00269233 0.00202854 0.00006087 0.00092380 0.00005217",
     ['<geom name="arm_link_el0_joint_collision" class="collision" type="box" size="0.025 0.045 0.065" pos="0.02 0 0.04" euler="0 0.5 0"/>',
      '<geom name="arm_link_el0_body_collision" class="collision" type="capsule" size="0.045 0.025" pos="0.08 0 0.07" euler="0 1.57079632679 0"/>']),
    ("arm_link_el1", "0.4033 0 0.075", "arm_el1", "1 0 0", 1.01754820,
     "-0.16867073 -0.01616121 0.00001149", "0.00117710 0.01649389 0.01689901 -0.00260549 0.00000156 -0.00000287",
     ['<geom name="arm_link_el1_main_collision" class="collision" type="capsule" size="0.035 0.095" pos="-0.15 0 0" euler="0 1.57079632679 0"/>',
      '<geom name="arm_link_el1_lip_collision" class="collision" type="sphere" size="0.04" pos="0 -0.035 0"/>']),
    ("arm_link_wr0", "0 0 0", "arm_wr0", "0 1 0", 0.58263740,
     "0.00952465 -0.01144406 0.00000186", "0.00046738 0.00044968 0.00053616 0.00006957 0.00000040 0.00000016",
     ['<geom name="arm_link_wr0_collision" class="collision" type="capsule" size="0.035 0.04" pos="0.02 0 0" euler="0 1.57079632679 0"/>']),
    ("arm_link_wr1", "0 0 0", "arm_wr1", "1 0 0", 0.93335298,
     "0.09751283 0.00009265 -0.01120523", "0.00098836 0.00197018 0.00165791 -0.00000126 -0.00036919 -0.00000074",
     ['<geom name="arm_link_wr1_collision" class="collision" type="box" size="0.03 0.04 0.0475" pos="0.11 0 -0.01"/>',
      '<geom name="bottom_jaw_collision" class="collision" type="box" size="0.03 0.025 0.01" pos="0.17 0 -0.0475"/>',
      '<geom name="front_jaw_collision" class="collision" type="box" size="0.016 0.015 0.01" pos="0.215 0 -0.0475"/>',
      '<geom name="front_jaw_tooth_collision" class="collision" type="box" size="0.005 0.01 0.005" pos="0.224 0 -0.039" euler="0 1 0"/>']),
    ("arm_link_fngr", "0.11745 0.0 0.014820", "arm_f1x", "0 1 0", 0.22383315,
     "0.03565178 0.00067200 -0.01227516", "0.00025226 0.00048453 0.00059145 -0.00000536 -0.00015067 0.00000184",
     ['<geom name="left_jaw_collision" class="collision" type="capsule" size="0.015 0.06" pos="0.057 0.023 -0.023" euler="-0.45 2.0 0"/>',
      '<geom name="right_jaw_collision" class="collision" type="capsule" size="0.015 0.06" pos="0.057 -0.023 -0.023" euler="0.45 2.0 0"/>']),
]


def _fmt(v: float) -> str:
    return f"{v:.8f}".rstrip("0").rstrip(".")


def _leg_xml(prefix: str, jp: str, sx: float, sy: float) -> str:
    hip_pos = f"{_fmt(sx * 0.29785)} {_fmt(sy * 0.055)} 0"
    hip_ipos = f"{_fmt(-sx * 0.01586739)} {_fmt(sy * 0.00855842)} 0.00000903"
    hip_inertia = (
        f"0.00122166 0.00158957 0.00172903 "
        f"{_fmt(-sx * sy * 0.00017754)} {_fmt(sx * 0.00000043)} {_fmt(-sy * 0.00000049)}"
    )
    ul_ipos = f"0.00214442 {_fmt(-sy * 0.01110184)} -0.07881204"
    ul_inertia = (
        f"0.02692501 0.02583907 0.00318737 "
        f"{_fmt(-sy * 0.00008782)} 0.00054873 {_fmt(sy * 0.00207146)}"
    )
    return f"""
    <body name="{prefix}_hip" pos="{hip_pos}">
      <inertial pos="{hip_ipos}" mass="1.13688339" fullinertia="{hip_inertia}"/>
      <joint name="{jp}_hx" class="hip_x" axis="1 0 0"/>
      <body name="{prefix}_upper_leg" pos="0 {_fmt(sy * 0.110945)} 0">
        <inertial pos="{ul_ipos}" mass="2.25620359" fullinertia="{ul_inertia}"/>
        <joint name="{jp}_hy" class="hip_y" axis="0 1 0"/>
        <geom name="{prefix}_upper_leg_collision" class="collision" type="capsule" size="0.05 0.165" pos="0 0 -0.13"/>
        <body name="{prefix}_lower_leg" pos="0.025 0 -0.3205">
          <inertial pos="0.00597360 0.0 -0.17466427" mass="0.33" fullinertia="0.00701356 0.00709946 0.00014529 0 0.00006600 0"/>
          <joint name="{jp}_kn" class="knee" axis="0 1 0"/>
          <geom name="{prefix}_lower_leg_collision" class="collision" type="capsule" size="0.03 0.15" pos="0 0 -0.155"/>
          <geom name="{prefix}_foot_collision" class="collision" type="sphere" size="0.036" pos="0 0 -0.3365"/>
          <site name="site_{prefix}" pos="0 0 -0.3365" size="0.01"/>
        </body>
      </body>
    </body>"""


def _arm_xml() -> str:
    parts = []
    for name, pos, joint, axis, mass, ipos, inertia, geoms in ARM_LINKS:
        parts.append(
            f'<body name="{name}" pos="{pos}">'
            f'<joint name="{joint}" class="{joint}" type="hinge" axis="{axis}"/>'
            f'<inertial mass="{mass}" pos="{ipos}" fullinertia="{inertia}"/>'
        )
        parts.extend(geoms)
        parts.append(f'<site name="site_{name}" pos="0 0 0" size="0.01"/>')
    parts.append("</body>" * len(ARM_LINKS))
    return "\n".join(parts)


def _defaults_xml() -> str:
    out = [
        '<default class="collision"><geom group="3" friction="0.15" priority="4"/></default>',
    ]
    for name, (fl, damp, arma, (lo, hi), kp, kv, fr) in JOINT_CLASSES.items():
        out.append(
            f'<default class="{name}">'
            f'<joint frictionloss="{fl}" damping="{damp}" armature="{arma}" range="{lo} {hi}"/>'
            f'<position kp="{kp}" kv="{kv}" ctrlrange="{lo} {hi}" forcerange="-{fr} {fr}"/>'
            "</default>"
        )
    return "\n".join(out)


def _actuators_xml() -> str:
    acts = []
    for _, jp, _, _ in LEGS:
        for suffix, cls in (("hx", "hip_x"), ("hy", "hip_y"), ("kn", "knee")):
            acts.append(f'<position name="act_{jp}_{suffix}" joint="{jp}_{suffix}" class="{cls}"/>')
    for name, _, joint, *_ in ARM_LINKS:
        acts.append(f'<position name="act_{joint}" joint="{joint}" class="{joint}"/>')
    return "<actuator>\n" + "\n".join(acts) + "\n</actuator>"


def _sensors_xml() -> str:
    s = [
        '<framepos name="sensor_body" objtype="site" objname="site_body" reftype="site" refname="site_object"/>',
        '<framexaxis name="body_x_axis" objtype="site" objname="site_body"/>',
        '<frameyaxis name="object_y_axis" objtype="site" objname="site_object"/>',
        '<framezaxis name="object_z_axis" objtype="site" objname="site_object"/>',
        '<framepos name="trace_fngr_site" objtype="site" objname="site_arm_link_fngr"/>',
        '<framepos name="fl_pos" objtype="site" objname="site_front_left"/>',
        '<framepos name="fr_pos" objtype="site" objname="site_front_right"/>',
        '<framepos name="hl_pos" objtype="site" objname="site_rear_left"/>',
        '<framepos name="hr_pos" objtype="site" objname="site_rear_right"/>',
    ]
    for name, *_ in ARM_LINKS:
        s.append(
            f'<framepos name="sensor_{name}" objtype="site" objname="site_{name}" '
            'reftype="site" refname="site_object"/>'
        )
    return "<sensor>\n" + "\n".join(s) + "\n</sensor>"


def _contacts_xml() -> str:
    excludes = [
        ("arm_link_sh0", "arm_link_el1"),
        ("arm_link_sh1", "arm_link_el0"),
        ("arm_link_sh1", "arm_link_el1"),
    ]
    for prefix, *_ in LEGS:
        excludes.append(("body", f"{prefix}_upper_leg"))
        excludes.append(("arm_link_sh0", f"{prefix}_upper_leg"))
    rows = [f'<exclude body1="{a}" body2="{b}"/>' for a, b in excludes]
    return "<contact>\n" + "\n".join(rows) + "\n</contact>"


def build_spot_xml(
    extra_worldbody: str = "", extra_assets: str = "", world_object_site: bool = True
) -> str:
    """Full Spot scene; ``extra_worldbody`` injects task objects (box, tire).

    ``world_object_site=False`` drops the world-frame site_object so a task
    object can own it instead (the reference's spot_box/spot_tire scenes put
    site_object on the object, making the relative sensors object-centric).
    """
    legs = "\n".join(_leg_xml(p, jp, sx, sy) for p, jp, sx, sy in LEGS)
    return f"""
<mujoco model="spot_tpu">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.01" integrator="implicitfast" density="1"/>
  <default>
    {_defaults_xml()}
  </default>
  <worldbody>
    <geom name="ground" type="plane" size="10 10 0.01" class="collision" priority="5" friction="0.7"/>
    <body name="body" pos="0 0 0.7">
      <joint name="base" type="free"/>
      <inertial mass="16.70765207" pos="0 0 -0.00496172" fullinertia="0.081543792 0.549231154 0.569454373 0 0 0"/>
      <geom name="body_collision" class="collision" type="box" size="0.42 0.11 0.08"/>
      <site name="site_body" pos="0 0 0.1" size="0.01"/>
      {legs}
      {_arm_xml()}
    </body>
    {('<site name="site_object" pos="0 0 0" size="0.01"/>' if world_object_site else "")}
    {extra_worldbody}
  </worldbody>
  {_actuators_xml()}
  {_sensors_xml()}
  {_contacts_xml()}
</mujoco>
"""


BOX_WORLDBODY = """
    <body name="box_body" pos="2 0 0.254">
      <joint name="box_joint" type="free"/>
      <inertial pos="0 0 0" mass="1.5" diaginertia="0.1445 0.1445 0.1445"/>
      <geom name="box_collision" type="box" size="0.254 0.254 0.254" class="collision" priority="4"/>
      <site name="site_object" pos="0 0 0" size="0.01"/>
    </body>
"""

# the reference's own primitive proxy for the tire mesh stack
# (objects/tire/tire.xml: object_primitive_approx cylinder 0.33 x 0.17)
TIRE_WORLDBODY = """
    <body name="tire" pos="2 0 0.35">
      <joint name="tire_joint" type="free"/>
      <inertial pos="0 0 0" mass="15.3" diaginertia="0.57 0.96 0.57"/>
      <geom name="tire_collision" type="cylinder" size="0.33 0.17" quat="1 1 0 0" class="collision" priority="4" friction="0.9"/>
      <site name="site_object" pos="0 0 0" size="0.01"/>
    </body>
"""

_SPOT_VARIANTS = {
    "spot_base": dict(extra_worldbody="", world_object_site=True),
    "spot_navigate": dict(extra_worldbody="", world_object_site=True),
    "spot_box_push": dict(extra_worldbody=BOX_WORLDBODY, world_object_site=False),
    "spot_tire_roll": dict(extra_worldbody=TIRE_WORLDBODY, world_object_site=False),
    "spot_tire_upright": dict(extra_worldbody=TIRE_WORLDBODY, world_object_site=False),
}


def spot_xml(variant: str = "spot_base", extra_worldbody: str = "") -> str:
    """The generated scene MJCF of a variant, as a string."""
    if not variant.startswith("spot"):
        variant = f"spot_{variant}"
    kwargs = _SPOT_VARIANTS.get(variant, dict(extra_worldbody=extra_worldbody, world_object_site=True))
    return build_spot_xml(**kwargs)
