"""The benchmark's TPC-H plans: a frozen copy of the program's 22 plan
builders, so that a later rewrite of a plan inside the program does not
move the yardstick.

Built with the program's plan API (``PlanBuilder`` over
``velox_tpu_torch.core.plan``), in the shapes of Velox's
``velox/exec/tests/utils/TpchQueryBuilder.cpp``. Q1, Q3 and Q6 take the
substitution parameters of TPC-H v3.0.1 §2.4.1.3, §2.4.3.3 and
§2.4.6.3; the other builders keep the parameters they had. ``topn`` is
the orderBy query of Velox's TPC-H benchmark configurations: ORDER BY
l_shipdate, l_orderkey LIMIT 1000. ``PLANS`` maps each query's name to
its builder.
"""

from __future__ import annotations

import datetime

from velox_tpu_torch.core import plan as P
from velox_tpu_torch.testing.plan_builder import PlanBuilder


def q6(connector_id: str = "tpch", year: int = 1994,
       discount: float = 0.06, quantity: int = 24) -> P.PlanNode:
    """Forecasting revenue change (TpchQueryBuilder.cpp:723); DATE is
    January 1 of ``year``."""
    return (
        PlanBuilder()
        .table_scan(
            "lineitem",
            ["l_shipdate", "l_extendedprice", "l_quantity", "l_discount"],
            connector_id=connector_id,
            filter=f"l_shipdate >= date '{year}-01-01' and "
                   f"l_shipdate < date '{year + 1}-01-01' and "
                   f"l_discount between {discount - 0.01:.2f} and "
                   f"{discount + 0.01:.2f} and "
                   f"l_quantity < {quantity:.1f}")
        .project(["l_extendedprice * l_discount as revenue"])
        .single_aggregation([], ["sum(revenue) as revenue"])
        .plan()
    )


def q1(connector_id: str = "tpch", delta: int = 90) -> P.PlanNode:
    """Pricing summary report (TpchQueryBuilder.cpp:192): lines shipped
    up to ``delta`` days before 1998-12-01."""
    cut = datetime.date(1998, 12, 1) - datetime.timedelta(days=delta)
    return (
        PlanBuilder()
        .table_scan(
            "lineitem",
            ["l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_shipdate"],
            connector_id=connector_id,
            filter=f"l_shipdate <= date '{cut.isoformat()}'")
        .project([
            "l_returnflag", "l_linestatus", "l_quantity",
            "l_extendedprice",
            "l_extendedprice * (1.0 - l_discount) as l_sum_disc_price",
            "l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax)"
            " as l_sum_charge",
            "l_discount"])
        .partial_aggregation(
            ["l_returnflag", "l_linestatus"],
            ["sum(l_quantity) as sum_qty",
             "sum(l_extendedprice) as sum_base_price",
             "sum(l_sum_disc_price) as sum_disc_price",
             "sum(l_sum_charge) as sum_charge",
             "avg(l_quantity) as avg_qty",
             "avg(l_extendedprice) as avg_price",
             "avg(l_discount) as avg_disc",
             "count() as count_order"])
        .final_aggregation()
        .order_by(["l_returnflag", "l_linestatus"])
        .plan()
    )


def q3(connector_id: str = "tpch", segment: str = "BUILDING",
       date: str = "1995-03-15") -> P.PlanNode:
    """Shipping priority (TpchQueryBuilder.cpp:446): customer x orders x
    lineitem, group by orderkey/orderdate/shippriority, top 10 by revenue;
    SEGMENT and DATE are the spec's parameters."""
    b = PlanBuilder()
    customers = (
        b.new_builder()
        .table_scan("customer", ["c_custkey", "c_mktsegment"],
                    connector_id=connector_id,
                    filter=f"c_mktsegment = '{segment}'")
        .project(["c_custkey"])
    )
    orders = (
        b.table_scan(
            "orders",
            ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
            connector_id=connector_id,
            filter=f"o_orderdate < date '{date}'")
        .hash_join(["o_custkey"], ["c_custkey"], customers,
                   output=["o_orderkey", "o_orderdate", "o_shippriority"],
                   join_type="left_semi_filter")
    )
    plan = (
        b.new_builder()
        .table_scan(
            "lineitem",
            ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"],
            connector_id=connector_id,
            filter=f"l_shipdate > date '{date}'")
        .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                   output=["l_orderkey", "l_extendedprice", "l_discount",
                           "o_orderdate", "o_shippriority"])
        .project(["l_orderkey",
                  "l_extendedprice * (1.0 - l_discount) as part_revenue",
                  "o_orderdate", "o_shippriority"])
        .single_aggregation(
            ["l_orderkey", "o_orderdate", "o_shippriority"],
            ["sum(part_revenue) as revenue"])
        .project(["l_orderkey", "revenue", "o_orderdate", "o_shippriority"])
        .top_n(["revenue DESC", "o_orderdate"], 10)
        .plan()
    )
    return plan


def q18(connector_id: str = "tpch",
        threshold: float = 300.0) -> P.PlanNode:
    """Large volume customer (TpchQueryBuilder.cpp:1881): orderkeys whose
    lineitem quantity sum > `threshold` (spec value 300; tests lower it at
    tiny scale factors where no order qualifies), joined back to orders
    and customer."""
    b = PlanBuilder()
    big_orders = (
        b.table_scan("lineitem", ["l_orderkey", "l_quantity"],
                     connector_id=connector_id)
        .single_aggregation(["l_orderkey"],
                            ["sum(l_quantity) as quantity"])
        .filter(f"quantity > {threshold:.1f}")
    )
    customers = (
        b.new_builder()
        .table_scan("customer", ["c_custkey", "c_name"],
                    connector_id=connector_id)
    )
    plan = (
        b.new_builder()
        .table_scan(
            "orders",
            ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"],
            connector_id=connector_id)
        .hash_join(["o_orderkey"], ["l_orderkey"], big_orders,
                   output=["o_orderkey", "o_custkey", "o_orderdate",
                           "o_totalprice", "quantity"])
        .hash_join(["o_custkey"], ["c_custkey"], customers,
                   output=["c_name", "c_custkey", "o_orderkey",
                           "o_orderdate", "o_totalprice", "quantity"])
        .top_n(["o_totalprice DESC", "o_orderdate"], 100)
        .plan()
    )
    return plan


def q2(connector_id: str = "tpch") -> P.PlanNode:
    """Minimum cost supplier (ref TpchQueryBuilder shape): the correlated
    MIN(ps_supplycost) subquery becomes an aggregate over the joined
    part x partsupp-in-region tree, joined back on (partkey, cost)."""
    cid = connector_id
    b = PlanBuilder()
    region = (b.new_builder()
              .table_scan("region", ["r_regionkey", "r_name"],
                          connector_id=cid, filter="r_name = 'EUROPE'")
              .project(["r_regionkey"]))
    nation = (b.new_builder()
              .table_scan("nation",
                          ["n_nationkey", "n_name", "n_regionkey"],
                          connector_id=cid)
              .hash_join(["n_regionkey"], ["r_regionkey"], region,
                         output=["n_nationkey", "n_name"]))
    supplier = (b.new_builder()
                .table_scan("supplier",
                            ["s_suppkey", "s_name", "s_address",
                             "s_nationkey", "s_phone", "s_acctbal",
                             "s_comment"], connector_id=cid)
                .hash_join(["s_nationkey"], ["n_nationkey"], nation,
                           output=["s_suppkey", "s_name", "s_address",
                                   "s_phone", "s_acctbal", "s_comment",
                                   "n_name"]))
    part = (b.new_builder()
            .table_scan("part", ["p_partkey", "p_mfgr", "p_size",
                                 "p_type"], connector_id=cid,
                        filter="p_size = 15 and p_type like '%BRASS'")
            .project(["p_partkey", "p_mfgr"]))
    j = (b.table_scan("partsupp",
                      ["ps_partkey", "ps_suppkey", "ps_supplycost"],
                      connector_id=cid)
         .hash_join(["ps_suppkey"], ["s_suppkey"], supplier,
                    output=["ps_partkey", "ps_supplycost", "s_name",
                            "s_address", "s_phone", "s_acctbal",
                            "s_comment", "n_name"])
         .hash_join(["ps_partkey"], ["p_partkey"], part,
                    output=["ps_partkey", "ps_supplycost", "s_name",
                            "s_address", "s_phone", "s_acctbal",
                            "s_comment", "n_name", "p_mfgr"]))
    mincost = (j.tee()
               .single_aggregation(["ps_partkey"],
                                   ["min(ps_supplycost) as mincost"]))
    return (j.hash_join(["ps_partkey", "ps_supplycost"],
                        ["ps_partkey", "mincost"], mincost,
                        output=["s_acctbal", "s_name", "n_name",
                                "ps_partkey", "p_mfgr", "s_address",
                                "s_phone", "s_comment"])
            .top_n(["s_acctbal DESC", "n_name", "s_name", "ps_partkey"],
                   100)
            .plan())


def q4(connector_id: str = "tpch") -> P.PlanNode:
    """Order priority checking: EXISTS(lineitem commit<receipt) as a
    left-semi join (ref exec/tests TpchQueryBuilder Q4 shape)."""
    cid = connector_id
    b = PlanBuilder()
    late = (b.new_builder()
            .table_scan("lineitem",
                        ["l_orderkey", "l_commitdate", "l_receiptdate"],
                        connector_id=cid,
                        filter="l_commitdate < l_receiptdate")
            .project(["l_orderkey"]))
    return (b.table_scan("orders",
                         ["o_orderkey", "o_orderdate", "o_orderpriority"],
                         connector_id=cid,
                         filter="o_orderdate >= date '1993-07-01' and "
                                "o_orderdate < date '1993-10-01'")
            .hash_join(["o_orderkey"], ["l_orderkey"], late,
                       output=["o_orderpriority"],
                       join_type="left_semi_filter")
            .single_aggregation(["o_orderpriority"],
                                ["count() as order_count"])
            .order_by(["o_orderpriority"])
            .plan())


def q5(connector_id: str = "tpch", region: str = "ASIA") -> P.PlanNode:
    """Local supplier volume: 6-way join, 1994 (spec default ASIA; TPC-H
    spec §2.4 substitution parameter)."""
    cid = connector_id
    b = PlanBuilder()
    regions = (b.new_builder()
               .table_scan("region", ["r_regionkey", "r_name"],
                           connector_id=cid, filter=f"r_name = '{region}'")
               .project(["r_regionkey"]))
    nation = (b.new_builder()
              .table_scan("nation",
                          ["n_nationkey", "n_name", "n_regionkey"],
                          connector_id=cid)
              .hash_join(["n_regionkey"], ["r_regionkey"], regions,
                         output=["n_nationkey", "n_name"]))
    supplier = (b.new_builder()
                .table_scan("supplier", ["s_suppkey", "s_nationkey"],
                            connector_id=cid)
                .hash_join(["s_nationkey"], ["n_nationkey"], nation,
                           output=["s_suppkey", "s_nationkey", "n_name"]))
    customer = (b.new_builder()
                .table_scan("customer", ["c_custkey", "c_nationkey"],
                            connector_id=cid))
    orders = (b.new_builder()
              .table_scan("orders",
                          ["o_orderkey", "o_custkey", "o_orderdate"],
                          connector_id=cid,
                          filter="o_orderdate >= date '1994-01-01' and "
                                 "o_orderdate < date '1995-01-01'")
              .hash_join(["o_custkey"], ["c_custkey"], customer,
                         output=["o_orderkey", "c_nationkey"]))
    return (b.table_scan("lineitem",
                         ["l_orderkey", "l_suppkey", "l_extendedprice",
                          "l_discount"], connector_id=cid)
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_suppkey", "l_extendedprice",
                               "l_discount", "c_nationkey"])
            .hash_join(["l_suppkey", "c_nationkey"],
                       ["s_suppkey", "s_nationkey"], supplier,
                       output=["l_extendedprice", "l_discount", "n_name"])
            .project(["n_name",
                      "l_extendedprice * (1.0 - l_discount) as volume"])
            .single_aggregation(["n_name"], ["sum(volume) as revenue"])
            .top_n(["revenue DESC"], 100)
            .plan())


def q7(connector_id: str = "tpch", nation1: str = "FRANCE",
       nation2: str = "GERMANY") -> P.PlanNode:
    """Volume shipping nation1 <-> nation2, 1995-1996 (spec defaults
    FRANCE/GERMANY; TPC-H spec §2.4 substitution parameters)."""
    cid = connector_id
    b = PlanBuilder()
    nation_filter = f"n_name = '{nation1}' or n_name = '{nation2}'"
    n1 = (b.new_builder()
          .table_scan("nation", ["n_nationkey", "n_name"],
                      connector_id=cid, filter=nation_filter)
          .project(["n_nationkey as s_nkey", "n_name as supp_nation"]))
    n2 = (b.new_builder()
          .table_scan("nation", ["n_nationkey", "n_name"],
                      connector_id=cid, filter=nation_filter)
          .project(["n_nationkey as c_nkey", "n_name as cust_nation"]))
    supplier = (b.new_builder()
                .table_scan("supplier", ["s_suppkey", "s_nationkey"],
                            connector_id=cid)
                .hash_join(["s_nationkey"], ["s_nkey"], n1,
                           output=["s_suppkey", "supp_nation"]))
    customer = (b.new_builder()
                .table_scan("customer", ["c_custkey", "c_nationkey"],
                            connector_id=cid)
                .hash_join(["c_nationkey"], ["c_nkey"], n2,
                           output=["c_custkey", "cust_nation"]))
    orders = (b.new_builder()
              .table_scan("orders", ["o_orderkey", "o_custkey"],
                          connector_id=cid)
              .hash_join(["o_custkey"], ["c_custkey"], customer,
                         output=["o_orderkey", "cust_nation"]))
    return (b.table_scan("lineitem",
                         ["l_orderkey", "l_suppkey", "l_shipdate",
                          "l_extendedprice", "l_discount"],
                         connector_id=cid,
                         filter="l_shipdate >= date '1995-01-01' and "
                                "l_shipdate <= date '1996-12-31'")
            .hash_join(["l_suppkey"], ["s_suppkey"], supplier,
                       output=["l_orderkey", "l_shipdate",
                               "l_extendedprice", "l_discount",
                               "supp_nation"])
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_shipdate", "l_extendedprice",
                               "l_discount", "supp_nation",
                               "cust_nation"])
            .filter(f"(supp_nation = '{nation1}' and "
                    f"cust_nation = '{nation2}')"
                    f" or (supp_nation = '{nation2}' and "
                    f"cust_nation = '{nation1}')")
            .project(["supp_nation", "cust_nation",
                      "year(l_shipdate) as l_year",
                      "l_extendedprice * (1.0 - l_discount) as volume"])
            .single_aggregation(["supp_nation", "cust_nation", "l_year"],
                                ["sum(volume) as revenue"])
            .order_by(["supp_nation", "cust_nation", "l_year"])
            .plan())


def q8(connector_id: str = "tpch", region: str = "AMERICA",
       p_type: str = "ECONOMY ANODIZED STEEL",
       nation: str = "BRAZIL") -> P.PlanNode:
    """National market share (spec defaults AMERICA / ECONOMY ANODIZED
    STEEL / BRAZIL; TPC-H spec §2.4 substitution parameters)."""
    cid = connector_id
    b = PlanBuilder()
    region = (b.new_builder()
              .table_scan("region", ["r_regionkey", "r_name"],
                          connector_id=cid, filter=f"r_name = '{region}'")
              .project(["r_regionkey"]))
    n1 = (b.new_builder()
          .table_scan("nation", ["n_nationkey", "n_regionkey"],
                      connector_id=cid)
          .hash_join(["n_regionkey"], ["r_regionkey"], region,
                     output=["n_nationkey"])
          .project(["n_nationkey as rn_key"]))
    n2 = (b.new_builder()
          .table_scan("nation", ["n_nationkey", "n_name"],
                      connector_id=cid)
          .project(["n_nationkey as s_nkey", "n_name as nation"]))
    customer = (b.new_builder()
                .table_scan("customer", ["c_custkey", "c_nationkey"],
                            connector_id=cid)
                .hash_join(["c_nationkey"], ["rn_key"], n1,
                           output=["c_custkey"]))
    orders = (b.new_builder()
              .table_scan("orders",
                          ["o_orderkey", "o_custkey", "o_orderdate"],
                          connector_id=cid,
                          filter="o_orderdate >= date '1995-01-01' and "
                                 "o_orderdate <= date '1996-12-31'")
              .hash_join(["o_custkey"], ["c_custkey"], customer,
                         output=["o_orderkey", "o_orderdate"]))
    part = (b.new_builder()
            .table_scan("part", ["p_partkey", "p_type"],
                        connector_id=cid,
                        filter=f"p_type = '{p_type}'")
            .project(["p_partkey"]))
    supplier = (b.new_builder()
                .table_scan("supplier", ["s_suppkey", "s_nationkey"],
                            connector_id=cid)
                .hash_join(["s_nationkey"], ["s_nkey"], n2,
                           output=["s_suppkey", "nation"]))
    return (b.table_scan("lineitem",
                         ["l_orderkey", "l_partkey", "l_suppkey",
                          "l_extendedprice", "l_discount"],
                         connector_id=cid)
            .hash_join(["l_partkey"], ["p_partkey"], part,
                       output=["l_orderkey", "l_suppkey",
                               "l_extendedprice", "l_discount"])
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_suppkey", "l_extendedprice",
                               "l_discount", "o_orderdate"])
            .hash_join(["l_suppkey"], ["s_suppkey"], supplier,
                       output=["l_extendedprice", "l_discount",
                               "o_orderdate", "nation"])
            .project(["year(o_orderdate) as o_year",
                      "l_extendedprice * (1.0 - l_discount) as volume",
                      "nation"])
            .project(["o_year", "volume",
                      f"case when nation = '{nation}' then volume "
                      "else 0.0000 end as brazil_vol"])
            .single_aggregation(
                ["o_year"],
                ["sum(brazil_vol) as brazil_volume",
                 "sum(volume) as total_volume"])
            .project(["o_year",
                      "cast(brazil_volume as double) / "
                      "cast(total_volume as double) as mkt_share"])
            .order_by(["o_year"])
            .plan())


def q9(connector_id: str = "tpch") -> P.PlanNode:
    """Product type profit measure: parts with 'green' in the name."""
    cid = connector_id
    b = PlanBuilder()
    part = (b.new_builder()
            .table_scan("part", ["p_partkey", "p_name"],
                        connector_id=cid,
                        filter="p_name like '%green%'")
            .project(["p_partkey"]))
    nation = (b.new_builder()
              .table_scan("nation", ["n_nationkey", "n_name"],
                          connector_id=cid))
    supplier = (b.new_builder()
                .table_scan("supplier", ["s_suppkey", "s_nationkey"],
                            connector_id=cid)
                .hash_join(["s_nationkey"], ["n_nationkey"], nation,
                           output=["s_suppkey", "n_name"]))
    partsupp = (b.new_builder()
                .table_scan("partsupp",
                            ["ps_partkey", "ps_suppkey",
                             "ps_supplycost"], connector_id=cid))
    orders = (b.new_builder()
              .table_scan("orders", ["o_orderkey", "o_orderdate"],
                          connector_id=cid))
    return (b.table_scan("lineitem",
                         ["l_orderkey", "l_partkey", "l_suppkey",
                          "l_quantity", "l_extendedprice", "l_discount"],
                         connector_id=cid)
            .hash_join(["l_partkey"], ["p_partkey"], part,
                       output=["l_orderkey", "l_partkey", "l_suppkey",
                               "l_quantity", "l_extendedprice",
                               "l_discount"])
            .hash_join(["l_suppkey"], ["s_suppkey"], supplier,
                       output=["l_orderkey", "l_partkey", "l_suppkey",
                               "l_quantity", "l_extendedprice",
                               "l_discount", "n_name"])
            .hash_join(["l_partkey", "l_suppkey"],
                       ["ps_partkey", "ps_suppkey"], partsupp,
                       output=["l_orderkey", "l_quantity",
                               "l_extendedprice", "l_discount",
                               "ps_supplycost", "n_name"])
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_quantity", "l_extendedprice",
                               "l_discount", "ps_supplycost", "n_name",
                               "o_orderdate"])
            .project(["n_name as nation",
                      "year(o_orderdate) as o_year",
                      "l_extendedprice * (1.0 - l_discount) - "
                      "ps_supplycost * l_quantity as amount"])
            .single_aggregation(["nation", "o_year"],
                                ["sum(amount) as sum_profit"])
            .order_by(["nation", "o_year DESC"])
            .plan())


def q10(connector_id: str = "tpch") -> P.PlanNode:
    """Returned item reporting: top 20 customers by lost revenue."""
    cid = connector_id
    b = PlanBuilder()
    nation = (b.new_builder()
              .table_scan("nation", ["n_nationkey", "n_name"],
                          connector_id=cid))
    customer = (b.new_builder()
                .table_scan("customer",
                            ["c_custkey", "c_name", "c_acctbal",
                             "c_address", "c_nationkey", "c_phone",
                             "c_comment"], connector_id=cid)
                .hash_join(["c_nationkey"], ["n_nationkey"], nation,
                           output=["c_custkey", "c_name", "c_acctbal",
                                   "c_address", "c_phone", "c_comment",
                                   "n_name"]))
    orders = (b.new_builder()
              .table_scan("orders",
                          ["o_orderkey", "o_custkey", "o_orderdate"],
                          connector_id=cid,
                          filter="o_orderdate >= date '1993-10-01' and "
                                 "o_orderdate < date '1994-01-01'")
              .hash_join(["o_custkey"], ["c_custkey"], customer,
                         output=["o_orderkey", "c_custkey", "c_name",
                                 "c_acctbal", "c_address", "c_phone",
                                 "c_comment", "n_name"]))
    return (b.table_scan("lineitem",
                         ["l_orderkey", "l_returnflag",
                          "l_extendedprice", "l_discount"],
                         connector_id=cid,
                         filter="l_returnflag = 'R'")
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_extendedprice", "l_discount",
                               "c_custkey", "c_name", "c_acctbal",
                               "c_address", "c_phone", "c_comment",
                               "n_name"])
            .project(["c_custkey", "c_name", "c_acctbal", "c_address",
                      "c_phone", "c_comment", "n_name",
                      "l_extendedprice * (1.0 - l_discount) as rev"])
            .single_aggregation(
                ["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                 "c_address", "c_comment"],
                ["sum(rev) as revenue"])
            .top_n(["revenue DESC", "c_custkey"], 20)
            .plan())


def q11(connector_id: str = "tpch", fraction: float = 0.0001
        ) -> P.PlanNode:
    """Important stock identification (GERMANY): per-part value vs a
    global-fraction threshold (cross join with the single-row total).
    ``fraction`` is the TPC-H spec §2.4 substitution parameter, 0.0001 /
    SF in the spec; 0.0001 by default."""
    cid = connector_id
    b = PlanBuilder()
    nation = (b.new_builder()
              .table_scan("nation", ["n_nationkey", "n_name"],
                          connector_id=cid,
                          filter="n_name = 'GERMANY'")
              .project(["n_nationkey"]))
    supplier = (b.new_builder()
                .table_scan("supplier", ["s_suppkey", "s_nationkey"],
                            connector_id=cid)
                .hash_join(["s_nationkey"], ["n_nationkey"], nation,
                           output=["s_suppkey"]))
    j = (b.table_scan("partsupp",
                      ["ps_partkey", "ps_suppkey", "ps_availqty",
                       "ps_supplycost"], connector_id=cid)
         .hash_join(["ps_suppkey"], ["s_suppkey"], supplier,
                    output=["ps_partkey", "ps_availqty",
                            "ps_supplycost"])
         .project(["ps_partkey",
                   "ps_supplycost * ps_availqty as pvalue"]))
    total = (j.tee()
             .single_aggregation([], ["sum(pvalue) as total"])
             .enforce_single_row())
    return (j.single_aggregation(["ps_partkey"],
                                 ["sum(pvalue) as value"])
            .nested_loop_join(total)
            # a DOUBLE literal of 17 significant digits reads back as
            # ``fraction`` itself, at any scale factor's 0.0001 / SF
            .filter("cast(value as double) > cast(total as double) * "
                    + f"{fraction:.17e}")
            .project(["ps_partkey", "value"])
            .top_n(["value DESC"], 1000)
            .plan())


def q12(connector_id: str = "tpch") -> P.PlanNode:
    """Shipping modes and order priority (MAIL/SHIP, 1994)."""
    cid = connector_id
    b = PlanBuilder()
    orders = (b.new_builder()
              .table_scan("orders", ["o_orderkey", "o_orderpriority"],
                          connector_id=cid))
    return (b.table_scan("lineitem",
                         ["l_orderkey", "l_shipmode", "l_shipdate",
                          "l_commitdate", "l_receiptdate"],
                         connector_id=cid,
                         filter="(l_shipmode = 'MAIL' or "
                                "l_shipmode = 'SHIP') and "
                                "l_commitdate < l_receiptdate and "
                                "l_shipdate < l_commitdate and "
                                "l_receiptdate >= date '1994-01-01' and "
                                "l_receiptdate < date '1995-01-01'")
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_shipmode", "o_orderpriority"])
            .project(["l_shipmode",
                      "case when o_orderpriority = '1-URGENT' or "
                      "o_orderpriority = '2-HIGH' then 1 else 0 end "
                      "as high",
                      "case when o_orderpriority = '1-URGENT' or "
                      "o_orderpriority = '2-HIGH' then 0 else 1 end "
                      "as low"])
            .single_aggregation(["l_shipmode"],
                                ["sum(high) as high_line_count",
                                 "sum(low) as low_line_count"])
            .order_by(["l_shipmode"])
            .plan())


def q13(connector_id: str = "tpch") -> P.PlanNode:
    """Customer distribution: LEFT join + two-level aggregation."""
    cid = connector_id
    b = PlanBuilder()
    orders = (b.new_builder()
              .table_scan("orders",
                          ["o_orderkey", "o_custkey", "o_comment"],
                          connector_id=cid,
                          filter="o_comment not like "
                                 "'%special%requests%'")
              .project(["o_orderkey", "o_custkey"]))
    return (b.table_scan("customer", ["c_custkey"], connector_id=cid)
            .hash_join(["c_custkey"], ["o_custkey"], orders,
                       output=["c_custkey", "o_orderkey"],
                       join_type="left")
            .single_aggregation(["c_custkey"],
                                ["count(o_orderkey) as c_count"])
            .single_aggregation(["c_count"], ["count() as custdist"])
            .top_n(["custdist DESC", "c_count DESC"], 1000)
            .plan())


def q14(connector_id: str = "tpch") -> P.PlanNode:
    """Promotion effect (1995-09)."""
    cid = connector_id
    b = PlanBuilder()
    part = (b.new_builder()
            .table_scan("part", ["p_partkey", "p_type"],
                        connector_id=cid))
    return (b.table_scan("lineitem",
                         ["l_partkey", "l_shipdate", "l_extendedprice",
                          "l_discount"], connector_id=cid,
                         filter="l_shipdate >= date '1995-09-01' and "
                                "l_shipdate < date '1995-10-01'")
            .hash_join(["l_partkey"], ["p_partkey"], part,
                       output=["l_extendedprice", "l_discount",
                               "p_type"])
            .project(["l_extendedprice * (1.0 - l_discount) as rev",
                      "case when p_type like 'PROMO%' then 1 else 0 end"
                      " as promo"])
            .project(["rev", "case when promo = 1 then rev else "
                             "0.00000 end as promo_rev"])
            .single_aggregation([], ["sum(promo_rev) as promo_revenue",
                                     "sum(rev) as total_revenue"])
            .project(["cast(promo_revenue as double) * 100.0 / "
                      "cast(total_revenue as double) as promo_pct"])
            .plan())


def q15(connector_id: str = "tpch") -> P.PlanNode:
    """Top supplier: revenue view + max join-back."""
    cid = connector_id
    b = PlanBuilder()
    rev = (b.new_builder()
           .table_scan("lineitem",
                       ["l_suppkey", "l_shipdate", "l_extendedprice",
                        "l_discount"], connector_id=cid,
                       filter="l_shipdate >= date '1996-01-01' and "
                              "l_shipdate < date '1996-04-01'")
           .project(["l_suppkey",
                     "l_extendedprice * (1.0 - l_discount) as rev"])
           .single_aggregation(["l_suppkey"],
                               ["sum(rev) as total_revenue"]))
    maxrev = (rev.tee()
              .single_aggregation([], ["max(total_revenue) as maxrev"]))
    supplier = (b.new_builder()
                .table_scan("supplier",
                            ["s_suppkey", "s_name", "s_address",
                             "s_phone"], connector_id=cid))
    return (rev.hash_join(["total_revenue"], ["maxrev"], maxrev,
                          output=["l_suppkey", "total_revenue"])
            .hash_join(["l_suppkey"], ["s_suppkey"], supplier,
                       output=["s_suppkey", "s_name", "s_address",
                               "s_phone", "total_revenue"])
            .order_by(["s_suppkey"])
            .plan())


def q16(connector_id: str = "tpch") -> P.PlanNode:
    """Parts/supplier relationship: NOT-IN anti join + COUNT(DISTINCT)
    via a two-level aggregation."""
    cid = connector_id
    b = PlanBuilder()
    bad_supp = (b.new_builder()
                .table_scan("supplier", ["s_suppkey", "s_comment"],
                            connector_id=cid,
                            filter="s_comment like "
                                   "'%Customer%Complaints%'")
                .project(["s_suppkey"]))
    part = (b.new_builder()
            .table_scan("part", ["p_partkey", "p_brand", "p_type",
                                 "p_size"], connector_id=cid,
                        filter="p_brand <> 'Brand#45' and "
                               "not (p_type like 'MEDIUM POLISHED%') "
                               "and p_size in "
                               "(49, 14, 23, 45, 19, 3, 36, 9)"))
    return (b.table_scan("partsupp", ["ps_partkey", "ps_suppkey"],
                         connector_id=cid)
            .hash_join(["ps_suppkey"], ["s_suppkey"], bad_supp,
                       output=["ps_partkey", "ps_suppkey"],
                       join_type="anti")
            .hash_join(["ps_partkey"], ["p_partkey"], part,
                       output=["p_brand", "p_type", "p_size",
                               "ps_suppkey"])
            .single_aggregation(["p_brand", "p_type", "p_size",
                                 "ps_suppkey"], ["count() as dummy"])
            .single_aggregation(["p_brand", "p_type", "p_size"],
                                ["count() as supplier_cnt"])
            .top_n(["supplier_cnt DESC", "p_brand", "p_type", "p_size"],
                   1000)
            .plan())


def q17(connector_id: str = "tpch", brand: str = "Brand#23",
        container: str = "MED BOX") -> P.PlanNode:
    """Small-quantity-order revenue: correlated AVG join-back (spec
    defaults Brand#23 / MED BOX; TPC-H §2.4 substitution parameters)."""
    cid = connector_id
    b = PlanBuilder()
    avg_qty = (b.new_builder()
               .table_scan("lineitem", ["l_partkey", "l_quantity"],
                           connector_id=cid)
               .single_aggregation(["l_partkey"],
                                   ["avg(l_quantity) as aq"])
               .project(["l_partkey as ap_key", "aq"]))
    part = (b.new_builder()
            .table_scan("part", ["p_partkey", "p_brand", "p_container"],
                        connector_id=cid,
                        filter=f"p_brand = '{brand}' and "
                               f"p_container = '{container}'")
            .project(["p_partkey"]))
    return (b.table_scan("lineitem",
                         ["l_partkey", "l_quantity", "l_extendedprice"],
                         connector_id=cid)
            .hash_join(["l_partkey"], ["p_partkey"], part,
                       output=["l_partkey", "l_quantity",
                               "l_extendedprice"])
            .hash_join(["l_partkey"], ["ap_key"], avg_qty,
                       output=["l_quantity", "l_extendedprice", "aq"])
            .filter("cast(l_quantity as double) < "
                    "0.2 * cast(aq as double)")
            .single_aggregation([], ["sum(l_extendedprice) as total"])
            .project(["cast(total as double) / 7.0 as avg_yearly"])
            .plan())


def q19(connector_id: str = "tpch", b1: str = "Brand#12",
        b2: str = "Brand#23", b3: str = "Brand#34",
        q1: int = 1, q2: int = 10, q3: int = 20) -> P.PlanNode:
    """Discounted revenue: OR of bracketed part/lineitem conditions as a
    join filter (brands and quantity windows are the TPC-H §2.4
    substitution parameters; each window is [qN, qN+10])."""
    cid = connector_id
    b = PlanBuilder()
    part = (b.new_builder()
            .table_scan("part", ["p_partkey", "p_brand", "p_container",
                                 "p_size"], connector_id=cid))
    return (b.table_scan("lineitem",
                         ["l_partkey", "l_quantity", "l_extendedprice",
                          "l_discount", "l_shipmode", "l_shipinstruct"],
                         connector_id=cid,
                         filter="(l_shipmode = 'AIR' or "
                                "l_shipmode = 'REG AIR') and "
                                "l_shipinstruct = 'DELIVER IN PERSON'")
            .hash_join(["l_partkey"], ["p_partkey"], part,
                       output=["l_quantity", "l_extendedprice",
                               "l_discount", "p_brand", "p_container",
                               "p_size"])
            .filter(
                f"(p_brand = '{b1}' and "
                "(p_container = 'SM CASE' or p_container = 'SM BOX' or "
                "p_container = 'SM PACK' or p_container = 'SM PKG') and "
                f"l_quantity >= {q1:.1f} and "
                f"l_quantity <= {q1 + 10:.1f} and "
                "p_size between 1 and 5) or "
                f"(p_brand = '{b2}' and "
                "(p_container = 'MED BAG' or p_container = 'MED BOX' or "
                "p_container = 'MED PKG' or p_container = 'MED PACK') "
                f"and l_quantity >= {q2:.1f} and "
                f"l_quantity <= {q2 + 10:.1f} and "
                "p_size between 1 and 10) or "
                f"(p_brand = '{b3}' and "
                "(p_container = 'LG CASE' or p_container = 'LG BOX' or "
                "p_container = 'LG PACK' or p_container = 'LG PKG') and "
                f"l_quantity >= {q3:.1f} and "
                f"l_quantity <= {q3 + 10:.1f} and "
                "p_size between 1 and 15)")
            .project(["l_extendedprice * (1.0 - l_discount) as rev"])
            .single_aggregation([], ["sum(rev) as revenue"])
            .plan())


def q20(connector_id: str = "tpch", color: str = "forest",
        nation: str = "CANADA") -> P.PlanNode:
    """Potential part promotion, 1994 (spec defaults CANADA / forest;
    TPC-H §2.4 substitution parameters)."""
    cid = connector_id
    b = PlanBuilder()
    forest_parts = (b.new_builder()
                    .table_scan("part", ["p_partkey", "p_name"],
                                connector_id=cid,
                                filter=f"p_name like '{color}%'")
                    .project(["p_partkey"]))
    half_qty = (b.new_builder()
                .table_scan("lineitem",
                            ["l_partkey", "l_suppkey", "l_shipdate",
                             "l_quantity"], connector_id=cid,
                            filter="l_shipdate >= date '1994-01-01' and"
                                   " l_shipdate < date '1995-01-01'")
                .single_aggregation(["l_partkey", "l_suppkey"],
                                    ["sum(l_quantity) as sq"]))
    eligible_ps = (b.new_builder()
                   .table_scan("partsupp",
                               ["ps_partkey", "ps_suppkey",
                                "ps_availqty"], connector_id=cid)
                   .hash_join(["ps_partkey"], ["p_partkey"],
                              forest_parts,
                              output=["ps_partkey", "ps_suppkey",
                                      "ps_availqty"],
                              join_type="left_semi_filter")
                   .hash_join(["ps_partkey", "ps_suppkey"],
                              ["l_partkey", "l_suppkey"], half_qty,
                              output=["ps_suppkey", "ps_availqty",
                                      "sq"])
                   .filter("cast(ps_availqty as double) > "
                           "0.5 * cast(sq as double)")
                   .project(["ps_suppkey"]))
    nation_sub = (b.new_builder()
                  .table_scan("nation", ["n_nationkey", "n_name"],
                              connector_id=cid,
                              filter=f"n_name = '{nation}'")
                  .project(["n_nationkey"]))
    return (b.table_scan("supplier",
                         ["s_suppkey", "s_name", "s_address",
                          "s_nationkey"], connector_id=cid)
            .hash_join(["s_nationkey"], ["n_nationkey"], nation_sub,
                       output=["s_suppkey", "s_name", "s_address"],
                       join_type="left_semi_filter")
            .hash_join(["s_suppkey"], ["ps_suppkey"], eligible_ps,
                       output=["s_name", "s_address"],
                       join_type="left_semi_filter")
            .order_by(["s_name"])
            .plan())


def q21(connector_id: str = "tpch") -> P.PlanNode:
    """Suppliers who kept orders waiting (SAUDI ARABIA): EXISTS as a
    filtered semi join, NOT EXISTS as a filtered anti join."""
    cid = connector_id
    b = PlanBuilder()
    nation = (b.new_builder()
              .table_scan("nation", ["n_nationkey", "n_name"],
                          connector_id=cid,
                          filter="n_name = 'SAUDI ARABIA'")
              .project(["n_nationkey"]))
    supplier = (b.new_builder()
                .table_scan("supplier",
                            ["s_suppkey", "s_name", "s_nationkey"],
                            connector_id=cid)
                .hash_join(["s_nationkey"], ["n_nationkey"], nation,
                           output=["s_suppkey", "s_name"]))
    orders = (b.new_builder()
              .table_scan("orders", ["o_orderkey", "o_orderstatus"],
                          connector_id=cid,
                          filter="o_orderstatus = 'F'")
              .project(["o_orderkey"]))
    l2 = (b.new_builder()
          .table_scan("lineitem", ["l_orderkey", "l_suppkey"],
                      connector_id=cid)
          .project(["l_orderkey as l2_orderkey",
                    "l_suppkey as l2_suppkey"]))
    l3 = (b.new_builder()
          .table_scan("lineitem",
                      ["l_orderkey", "l_suppkey", "l_receiptdate",
                       "l_commitdate"], connector_id=cid,
                      filter="l_receiptdate > l_commitdate")
          .project(["l_orderkey as l3_orderkey",
                    "l_suppkey as l3_suppkey"]))
    return (b.table_scan("lineitem",
                         ["l_orderkey", "l_suppkey", "l_receiptdate",
                          "l_commitdate"], connector_id=cid,
                         filter="l_receiptdate > l_commitdate")
            .hash_join(["l_suppkey"], ["s_suppkey"], supplier,
                       output=["l_orderkey", "l_suppkey", "s_name"])
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_orderkey", "l_suppkey", "s_name"],
                       join_type="left_semi_filter")
            .hash_join(["l_orderkey"], ["l2_orderkey"], l2,
                       output=["l_orderkey", "l_suppkey", "s_name"],
                       join_type="left_semi_filter",
                       filter="l2_suppkey <> l_suppkey")
            .hash_join(["l_orderkey"], ["l3_orderkey"], l3,
                       output=["s_name"],
                       join_type="anti",
                       filter="l3_suppkey <> l_suppkey")
            .single_aggregation(["s_name"], ["count() as numwait"])
            .top_n(["numwait DESC", "s_name"], 100)
            .plan())


def q22(connector_id: str = "tpch") -> P.PlanNode:
    """Global sales opportunity: phone-prefix country codes, positive-
    balance average (cross join), NOT EXISTS orders (anti join)."""
    cid = connector_id
    codes = ("13", "31", "23", "29", "30", "18", "17")
    code_pred = " or ".join(f"cntrycode = '{c}'" for c in codes)
    b = PlanBuilder()
    cust = (b.table_scan("customer",
                         ["c_custkey", "c_phone", "c_acctbal"],
                         connector_id=cid)
            .project(["c_custkey", "c_acctbal",
                      "substr(c_phone, 1, 2) as cntrycode"])
            .filter(code_pred))
    avg_bal = (cust.tee()
               .filter("c_acctbal > 0.00")
               .single_aggregation([], ["avg(c_acctbal) as ab"])
               .enforce_single_row())
    orders = (b.new_builder()
              .table_scan("orders", ["o_custkey"], connector_id=cid))
    return (cust.nested_loop_join(avg_bal)
            .filter("cast(c_acctbal as double) > cast(ab as double)")
            .hash_join(["c_custkey"], ["o_custkey"], orders,
                       output=["cntrycode", "c_acctbal"],
                       join_type="anti")
            .single_aggregation(["cntrycode"],
                                ["count() as numcust",
                                 "sum(c_acctbal) as totacctbal"])
            .order_by(["cntrycode"])
            .plan())


def topn(connector_id: str = "tpch") -> P.PlanNode:
    """The orderBy configuration of Velox's TPC-H benchmark: ORDER BY
    l_shipdate, l_orderkey LIMIT 1000 (run as a TopN)."""
    return (PlanBuilder()
            .table_scan("lineitem", ["l_shipdate", "l_orderkey"],
                        connector_id=connector_id)
            .order_by(["l_shipdate", "l_orderkey"]).limit(1000).plan())


PLANS = {f"q{q}": build for q, build in (
    (1, q1), (2, q2), (3, q3), (4, q4), (5, q5), (6, q6), (7, q7), (8, q8),
    (9, q9), (10, q10), (11, q11), (12, q12), (13, q13), (14, q14),
    (15, q15), (16, q16), (17, q17), (18, q18), (19, q19), (20, q20),
    (21, q21), (22, q22))}
PLANS["topn"] = topn
