"""Programmatic FR3 (Franka Research 3) pick scene generator, mesh-free (the
port's own copy of ``judo_tpu/models/fr3.py``, returning the MJCF as a string).

Kinematic frames, inertials, joint limits and actuator gains are the FR3's
published parameters (the reference uses the same arm —
judo/models/xml/fr3_components/*); the mesh collision geometry is replaced by
capsule/box primitives sized to the arm's links. Scene layout matches the
reference fr3_pick (table box + free cube + arm), including the
finger-coupling equality and the body-distance sensors the reward reads.
"""

from __future__ import annotations

# (name, pos, quat, joint(range, frcrange), inertial(pos, quat, mass, diag), collision geoms)
FR3_LINKS = [
    ("fr3_link1", "0 0 0.333", None, ("-2.7437 2.7437", 87),
     ("4.128e-07 -0.0181251 -0.0386036", "0.998098 -0.0605364 0.00380499 0.0110109", 2.92747,
      "0.0239286 0.0227246 0.00610634"),
     ['<geom name="l1_coll" class="collision" type="capsule" size="0.055 0.06" pos="0 0 -0.08"/>']),
    ("fr3_link2", "0 0 0", "1 -1 0 0", ("-1.7837 1.7837", 87),
     ("0.00318289 -0.0743222 0.00881461", "0.502599 0.584437 -0.465998 0.434366", 2.93554,
      "0.0629567 0.0411924 0.0246371"),
     ['<geom name="l2_coll" class="collision" type="capsule" size="0.055 0.06" pos="0 -0.08 0" zaxis="0 1 0"/>']),
    ("fr3_link3", "0 -0.316 0", "1 1 0 0", ("-2.9007 2.9007", 87),
     ("0.0407016 -0.00482006 -0.0289731", "0.921025 -0.244161 0.155272 0.260745", 2.2449,
      "0.0267409 0.0189869 0.0171587"),
     ['<geom name="l3_coll" class="collision" type="capsule" size="0.05 0.05" pos="0.04 0 -0.03"/>']),
    ("fr3_link4", "0.0825 0 0", "1 1 0 0", ("-3.0421 -0.1518", 87),
     ("-0.0459101 0.0630493 -0.00851879", "0.438018 0.803311 0.00937812 0.403414", 2.6156,
      "0.05139 0.0372717 0.0160047"),
     ['<geom name="l4_coll" class="collision" type="capsule" size="0.05 0.05" pos="-0.04 0.05 0"/>']),
    ("fr3_link5", "-0.0825 0.384 0", "1 -1 0 0", ("-2.8065 2.8065", 12),
     ("-0.00160396 0.0292536 -0.0972966", "0.919031 0.125604 0.0751531 -0.366003", 2.32712,
      "0.0579335 0.0449144 0.0130634"),
     ['<geom name="l5_coll" class="collision" type="capsule" size="0.045 0.11" pos="0 0.03 -0.11"/>']),
    ("fr3_link6", "0 0 0", "1 1 0 0", ("0.5445 4.5169", 12),
     ("0.0597131 -0.0410295 -0.0101693", "0.621301 0.552665 0.510011 0.220081", 1.81704,
      "0.0175039 0.0161123 0.00193529"),
     ['<geom name="l6_coll" class="collision" type="capsule" size="0.045 0.03" pos="0.05 -0.03 0"/>']),
    ("fr3_link7", "0.088 0 0", "1 1 0 0", ("-3.0159 3.0159", 12),
     ("0.00452258 0.00862619 -0.0161633", "0.727579 0.0978688 -0.24906 0.63168", 0.627143,
      "0.000223836 0.000223642 5.64132e-07"),
     ['<geom name="l7_coll" class="collision" type="capsule" size="0.04 0.02" pos="0 0 -0.02"/>']),
]

ACTUATOR_GAINS = [
    ("fr3_joint1", 4500, 450), ("fr3_joint2", 4500, 450), ("fr3_joint3", 3500, 350),
    ("fr3_joint4", 3500, 350), ("fr3_joint5", 2000, 200), ("fr3_joint6", 2000, 200),
    ("fr3_joint7", 2000, 200),
]


def build_fr3_pick_xml() -> str:
    links = []
    for name, pos, quat, (jrange, frc), (ipos, iquat, mass, diag), geoms in FR3_LINKS:
        joint = name.replace("link", "joint")
        quat_attr = f' quat="{quat}"' if quat else ""
        links.append(
            f'<body name="{name}" pos="{pos}"{quat_attr}>'
            f'<inertial pos="{ipos}" quat="{iquat}" mass="{mass}" diaginertia="{diag}"/>'
            f'<joint name="{joint}" class="fr3_joint" axis="0 0 1" range="{jrange}" actuatorfrcrange="-{frc} {frc}"/>'
        )
        links.extend(geoms)
    hand_and_fingers = """
      <body name="hand" pos="0 0 0.107" quat="0.9238795 0 0 -0.3826834">
        <inertial mass="0.73" pos="-0.01 0 0.03" diaginertia="0.001 0.0025 0.0017"/>
        <geom name="hand_coll" class="collision" type="box" size="0.035 0.05 0.05" pos="0 0 0.03"/>
        <site name="grasp_site" pos="0 0 0.1034"/>
        <body name="left_finger" pos="0 0 0.0584">
          <inertial mass="0.015" pos="0 0 0" diaginertia="2.375e-6 2.375e-6 7.5e-7"/>
          <joint name="finger_joint1" class="finger"/>
          <geom name="lf_coll" class="finger_coll" type="box" size="0.008 0.006 0.02" pos="0 0.006 0.035"/>
        </body>
        <body name="right_finger" pos="0 0 0.0584" quat="0 0 0 1">
          <inertial mass="0.015" pos="0 0 0" diaginertia="2.375e-6 2.375e-6 7.5e-7"/>
          <joint name="finger_joint2" class="finger"/>
          <geom name="rf_coll" class="finger_coll" type="box" size="0.008 0.006 0.02" pos="0 0.006 0.035"/>
        </body>
      </body>
    """
    links.append(hand_and_fingers)
    links.append("</body>" * len(FR3_LINKS))
    chain = "\n".join(links)

    acts = "\n".join(
        f'<position class="fr3_act" name="{j}" joint="{j}" kp="{kp}" kv="{kv}"/>'
        for j, kp, kv in ACTUATOR_GAINS
    )

    return f"""
<mujoco model="fr3_pick_tpu">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.004" integrator="implicitfast" impratio="10.0"/>
  <default>
    <default class="collision"><geom group="3" friction="0.6"/></default>
    <default class="finger_coll"><geom group="3" friction="1.2 0.05 0.001"/></default>
    <default class="fr3_joint"><joint damping="0.21" armature="0.195"/></default>
    <default class="fr3_act"><position inheritrange="1"/></default>
    <default class="finger"><joint axis="0 1 0" type="slide" range="0 0.04" damping="5"/></default>
  </default>

  <worldbody>
    <body name="table">
      <geom name="table" type="box" size="0.75 1.25 0.01" pos="0.5 0 -0.01"/>
    </body>
    <body name="object">
      <freejoint name="object_joint"/>
      <geom name="box" type="box" size="0.02 0.02 0.02" mass="0.1"/>
      <site name="object_site"/>
    </body>
    <body name="fr3">
      <body name="fr3_link0">
        <inertial mass="2.4" pos="-0.04 0 0.07" diaginertia="0.01 0.01 0.008"/>
        <geom name="l0_coll" class="collision" type="capsule" size="0.06 0.03" pos="0 0 0.05"/>
        {chain}
      </body>
    </body>
  </worldbody>

  <equality>
    <joint joint1="finger_joint1" joint2="finger_joint2" polycoef="0 1"/>
  </equality>

  <actuator>
    {acts}
    <position name="fr3_hand" joint="finger_joint1" ctrllimited="true" kp="500" kv="10" ctrlrange="0 0.08"/>
  </actuator>

  <sensor>
    <distance name="left_finger_obj" cutoff="1.0" body1="left_finger" body2="object"/>
    <distance name="right_finger_obj" cutoff="1.0" body1="right_finger" body2="object"/>
    <distance name="left_finger_table" cutoff="1.0" body1="left_finger" body2="table"/>
    <distance name="right_finger_table" cutoff="1.0" body1="right_finger" body2="table"/>
    <distance name="obj_table" cutoff="1.0" body1="object" body2="table"/>
    <framezaxis name="ee_z" objtype="body" objname="hand"/>
    <framepos name="trace_object" objtype="body" objname="object"/>
    <framepos name="trace_grasp_site" objtype="site" objname="grasp_site"/>
  </sensor>
</mujoco>
"""

