"""Oracle SQL for the 22 TPC-H queries, against SQLite.

A copy of ``tests/tpch_sql.py`` (which the reference's suites share) with
the four queries that file leaves to bespoke tests added: Q1, Q3, Q6 and
Q18 (whose ``threshold`` is a parameter here, as in ``tpch_plan``), and
Q5's ``region`` as a parameter (the real dbgen snapshot's ASIA selects no
row). The
port's golden tests and ``chip_smoke.py`` read it from the package, so
nothing outside it is needed; ``tests/test_torch_dbgen_golden.py`` holds
the shared entries equal to the reference's file.

The SQL is written against the engine's scaled-int money space (money
DECIMAL(12,2) -> cents, l_quantity -> hundredths) and epoch-day dates,
then divides back to dollars so results compare against the engine's
DECIMAL outputs. Q1's averages round half up in integer arithmetic, as
the engine's DECIMAL averages do.
"""

import numpy as np


def days(iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01"))
               .astype(int))


# per-query comparison knobs: (rel_tol, min_rows)
TOLERANCES = {17: (1e-6, 1), 20: (1e-9, 0)}

# each query's ORDER BY (TPC-H v3.0.1 section 2.4) over its output
# columns: [(column position, descending)], the first the most
# significant; a query without one compares as a multiset
ORDER_BY = {
    1: [(0, False), (1, False)],
    2: [(0, True), (2, False), (1, False), (3, False)],
    3: [(1, True), (2, False)],
    4: [(0, False)],
    5: [(1, True)],
    6: [],
    7: [(0, False), (1, False), (2, False)],
    8: [(0, False)],
    9: [(0, False), (1, True)],
    10: [(7, True)],
    11: [(1, True)],
    12: [(0, False)],
    13: [(1, True), (0, True)],
    14: [],
    15: [(0, False)],
    16: [(3, True), (0, False), (1, False), (2, False)],
    17: [],
    18: [(4, True), (3, False)],
    19: [],
    20: [(0, False)],
    21: [(1, True), (0, False)],
    22: [(0, False)],
}


def oracle_sql(q: int, **params) -> str:
    """Oracle SQL for query ``q``. Queries 5/7/8/17/18/19/20 accept the
    spec's substitution parameters (TPC-H spec §2.4: each query is defined
    with substitution parameters; the ORACLE_SQL defaults are the
    validation values) so tiny data snapshots can pick values that
    produce rows."""
    fn = _PARAM_SQL.get(q)
    if fn is None:
        if params:
            raise ValueError(f"Q{q} takes no parameters")
        return ORACLE_SQL[q]
    return fn(**params)


def _q5_sql(region="ASIA"):
    return f"""
      SELECT n_name,
             SUM(l_extendedprice * (100 - l_discount))/10000.0 AS revenue
      FROM customer, orders, lineitem, supplier, nation, region
      WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
        AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
        AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
        AND r_name = '{region}'
        AND o_orderdate >= {days('1994-01-01')}
        AND o_orderdate < {days('1995-01-01')}
      GROUP BY n_name ORDER BY revenue DESC"""


def _q7_sql(nation1="FRANCE", nation2="GERMANY"):
    return f"""
      SELECT supp_nation, cust_nation, l_year,
             SUM(volume)/10000.0 AS revenue
      FROM (SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
              CAST(STRFTIME('%Y', l_shipdate * 86400, 'unixepoch')
                   AS INTEGER) AS l_year,
              l_extendedprice * (100 - l_discount) AS volume
            FROM supplier, lineitem, orders, customer,
                 nation n1, nation n2
            WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
              AND c_custkey = o_custkey
              AND s_nationkey = n1.n_nationkey
              AND c_nationkey = n2.n_nationkey
              AND ((n1.n_name = '{nation1}' AND n2.n_name = '{nation2}')
                OR (n1.n_name = '{nation2}' AND n2.n_name = '{nation1}'))
              AND l_shipdate BETWEEN {days('1995-01-01')}
                  AND {days('1996-12-31')})
      GROUP BY supp_nation, cust_nation, l_year
      ORDER BY supp_nation, cust_nation, l_year"""


def _q8_sql(region="AMERICA", p_type="ECONOMY ANODIZED STEEL",
            nation="BRAZIL"):
    return f"""
      SELECT o_year,
             CAST(SUM(CASE WHEN nation = '{nation}' THEN volume ELSE 0
                  END) AS REAL) / SUM(volume) AS mkt_share
      FROM (SELECT CAST(STRFTIME('%Y', o_orderdate * 86400, 'unixepoch')
                        AS INTEGER) AS o_year,
              l_extendedprice * (100 - l_discount) AS volume,
              n2.n_name AS nation
            FROM part, supplier, lineitem, orders, customer,
                 nation n1, nation n2, region
            WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey
              AND l_orderkey = o_orderkey AND o_custkey = c_custkey
              AND c_nationkey = n1.n_nationkey
              AND n1.n_regionkey = r_regionkey AND r_name = '{region}'
              AND s_nationkey = n2.n_nationkey
              AND o_orderdate BETWEEN {days('1995-01-01')}
                  AND {days('1996-12-31')}
              AND p_type = '{p_type}')
      GROUP BY o_year ORDER BY o_year"""


def _q17_sql(brand="Brand#23", container="MED BOX"):
    return f"""
      SELECT SUM(l_extendedprice)/100.0/7.0 AS avg_yearly
      FROM lineitem, part
      WHERE p_partkey = l_partkey AND p_brand = '{brand}'
        AND p_container = '{container}'
        AND l_quantity < (SELECT 0.2 * AVG(l_quantity) FROM lineitem
                          WHERE l_partkey = p_partkey)"""


def _q19_sql(b1="Brand#12", b2="Brand#23", b3="Brand#34",
             q1=1, q2=10, q3=20):
    # quantities in whole units; the oracle speaks hundredths
    return f"""
      SELECT SUM(l_extendedprice * (100 - l_discount))/10000.0 AS revenue
      FROM lineitem, part
      WHERE (p_partkey = l_partkey AND p_brand = '{b1}'
        AND p_container IN ('SM CASE','SM BOX','SM PACK','SM PKG')
        AND l_quantity >= {q1 * 100} AND l_quantity <= {(q1 + 10) * 100}
        AND p_size BETWEEN 1 AND 5
        AND l_shipmode IN ('AIR', 'REG AIR')
        AND l_shipinstruct = 'DELIVER IN PERSON')
      OR (p_partkey = l_partkey AND p_brand = '{b2}'
        AND p_container IN ('MED BAG','MED BOX','MED PKG','MED PACK')
        AND l_quantity >= {q2 * 100} AND l_quantity <= {(q2 + 10) * 100}
        AND p_size BETWEEN 1 AND 10
        AND l_shipmode IN ('AIR', 'REG AIR')
        AND l_shipinstruct = 'DELIVER IN PERSON')
      OR (p_partkey = l_partkey AND p_brand = '{b3}'
        AND p_container IN ('LG CASE','LG BOX','LG PACK','LG PKG')
        AND l_quantity >= {q3 * 100} AND l_quantity <= {(q3 + 10) * 100}
        AND p_size BETWEEN 1 AND 15
        AND l_shipmode IN ('AIR', 'REG AIR')
        AND l_shipinstruct = 'DELIVER IN PERSON')"""


def _q20_sql(color="forest", nation="CANADA"):
    return f"""
      SELECT s_name, s_address FROM supplier, nation
      WHERE s_suppkey IN (
        SELECT ps_suppkey FROM partsupp
        WHERE ps_partkey IN (SELECT p_partkey FROM part
                             WHERE p_name LIKE '{color}%')
          AND ps_availqty > (
            SELECT 0.5 * SUM(l_quantity) / 100.0 FROM lineitem
            WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
              AND l_shipdate >= {days('1994-01-01')}
              AND l_shipdate < {days('1995-01-01')}))
        AND s_nationkey = n_nationkey AND n_name = '{nation}'
      ORDER BY s_name"""


_PARAM_SQL = {5: _q5_sql, 7: _q7_sql, 8: _q8_sql, 17: _q17_sql,
              19: _q19_sql, 20: _q20_sql}

ORACLE_SQL = {
    2: """
      SELECT s_acctbal/100.0, s_name, n_name, p_partkey, p_mfgr,
             s_address, s_phone, s_comment
      FROM part, supplier, partsupp, nation, region
      WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
        AND p_size = 15 AND p_type LIKE '%BRASS'
        AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
        AND r_name = 'EUROPE'
        AND ps_supplycost = (
          SELECT MIN(ps_supplycost) FROM partsupp, supplier, nation,
                 region
          WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
            AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
            AND r_name = 'EUROPE')
      ORDER BY s_acctbal DESC, n_name, s_name, p_partkey LIMIT 100""",
    4: f"""
      SELECT o_orderpriority, COUNT(*) AS order_count FROM orders
      WHERE o_orderdate >= {days('1993-07-01')}
        AND o_orderdate < {days('1993-10-01')}
        AND EXISTS (SELECT 1 FROM lineitem
                    WHERE l_orderkey = o_orderkey
                      AND l_commitdate < l_receiptdate)
      GROUP BY o_orderpriority ORDER BY o_orderpriority""",
    5: _q5_sql(),
    7: _q7_sql(),
    8: _q8_sql(),
    9: """
      SELECT nation, o_year, SUM(amount)/10000.0 AS sum_profit
      FROM (SELECT n_name AS nation,
              CAST(STRFTIME('%Y', o_orderdate * 86400, 'unixepoch')
                   AS INTEGER) AS o_year,
              l_extendedprice * (100 - l_discount)
                - ps_supplycost * l_quantity AS amount
            FROM part, supplier, lineitem, partsupp, orders, nation
            WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
              AND ps_partkey = l_partkey AND p_partkey = l_partkey
              AND o_orderkey = l_orderkey
              AND s_nationkey = n_nationkey
              AND p_name LIKE '%green%')
      GROUP BY nation, o_year ORDER BY nation, o_year DESC""",
    10: f"""
      SELECT c_custkey, c_name, c_acctbal/100.0, c_phone, n_name,
             c_address, c_comment,
             SUM(l_extendedprice * (100 - l_discount))/10000.0 AS revenue
      FROM customer, orders, lineitem, nation
      WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
        AND o_orderdate >= {days('1993-10-01')}
        AND o_orderdate < {days('1994-01-01')}
        AND l_returnflag = 'R' AND c_nationkey = n_nationkey
      GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
               c_comment
      ORDER BY revenue DESC, c_custkey LIMIT 20""",
    11: """
      SELECT ps_partkey,
             SUM(ps_supplycost * ps_availqty)/100.0 AS value
      FROM partsupp, supplier, nation
      WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
        AND n_name = 'GERMANY'
      GROUP BY ps_partkey
      HAVING SUM(ps_supplycost * ps_availqty) > (
        SELECT SUM(ps_supplycost * ps_availqty) * 0.0001
        FROM partsupp, supplier, nation
        WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
          AND n_name = 'GERMANY')
      ORDER BY value DESC""",
    12: f"""
      SELECT l_shipmode,
        SUM(CASE WHEN o_orderpriority = '1-URGENT'
                   OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END),
        SUM(CASE WHEN o_orderpriority <> '1-URGENT'
                  AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END)
      FROM orders, lineitem
      WHERE o_orderkey = l_orderkey
        AND l_shipmode IN ('MAIL', 'SHIP')
        AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
        AND l_receiptdate >= {days('1994-01-01')}
        AND l_receiptdate < {days('1995-01-01')}
      GROUP BY l_shipmode ORDER BY l_shipmode""",
    13: """
      SELECT c_count, COUNT(*) AS custdist
      FROM (SELECT c_custkey, COUNT(o_orderkey) AS c_count
            FROM customer LEFT OUTER JOIN orders ON
              c_custkey = o_custkey
              AND o_comment NOT LIKE '%special%requests%'
            GROUP BY c_custkey)
      GROUP BY c_count ORDER BY custdist DESC, c_count DESC""",
    14: f"""
      SELECT 100.0 * SUM(CASE WHEN p_type LIKE 'PROMO%'
               THEN l_extendedprice * (100 - l_discount) ELSE 0 END)
             / SUM(l_extendedprice * (100 - l_discount)) AS promo_pct
      FROM lineitem, part
      WHERE l_partkey = p_partkey
        AND l_shipdate >= {days('1995-09-01')}
        AND l_shipdate < {days('1995-10-01')}""",
    15: f"""
      WITH revenue AS (
        SELECT l_suppkey AS supplier_no,
               SUM(l_extendedprice * (100 - l_discount)) AS total_revenue
        FROM lineitem
        WHERE l_shipdate >= {days('1996-01-01')}
          AND l_shipdate < {days('1996-04-01')}
        GROUP BY l_suppkey)
      SELECT s_suppkey, s_name, s_address, s_phone,
             total_revenue/10000.0
      FROM supplier, revenue
      WHERE s_suppkey = supplier_no
        AND total_revenue = (SELECT MAX(total_revenue) FROM revenue)
      ORDER BY s_suppkey""",
    16: """
      SELECT p_brand, p_type, p_size,
             COUNT(DISTINCT ps_suppkey) AS supplier_cnt
      FROM partsupp, part
      WHERE p_partkey = ps_partkey AND p_brand <> 'Brand#45'
        AND p_type NOT LIKE 'MEDIUM POLISHED%'
        AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
        AND ps_suppkey NOT IN (SELECT s_suppkey FROM supplier
          WHERE s_comment LIKE '%Customer%Complaints%')
      GROUP BY p_brand, p_type, p_size
      ORDER BY supplier_cnt DESC, p_brand, p_type, p_size""",
    17: _q17_sql(),
    19: _q19_sql(),
    20: _q20_sql(),
    21: """
      SELECT s_name, COUNT(*) AS numwait
      FROM supplier, lineitem l1, orders, nation
      WHERE s_suppkey = l1.l_suppkey AND o_orderkey = l1.l_orderkey
        AND o_orderstatus = 'F'
        AND l1.l_receiptdate > l1.l_commitdate
        AND EXISTS (SELECT 1 FROM lineitem l2
          WHERE l2.l_orderkey = l1.l_orderkey
            AND l2.l_suppkey <> l1.l_suppkey)
        AND NOT EXISTS (SELECT 1 FROM lineitem l3
          WHERE l3.l_orderkey = l1.l_orderkey
            AND l3.l_suppkey <> l1.l_suppkey
            AND l3.l_receiptdate > l3.l_commitdate)
        AND s_nationkey = n_nationkey AND n_name = 'SAUDI ARABIA'
      GROUP BY s_name ORDER BY numwait DESC, s_name LIMIT 100""",
    22: """
      SELECT cntrycode, COUNT(*) AS numcust,
             SUM(c_acctbal)/100.0 AS totacctbal
      FROM (SELECT SUBSTR(c_phone, 1, 2) AS cntrycode, c_acctbal
            FROM customer
            WHERE SUBSTR(c_phone, 1, 2) IN
                  ('13','31','23','29','30','18','17')
              AND c_acctbal > (
                SELECT AVG(c_acctbal) FROM customer
                WHERE c_acctbal > 0 AND SUBSTR(c_phone, 1, 2) IN
                      ('13','31','23','29','30','18','17'))
              AND NOT EXISTS (SELECT 1 FROM orders
                              WHERE o_custkey = c_custkey))
      GROUP BY cntrycode ORDER BY cntrycode""",
}


def _q18_sql(threshold=300.0):
    return f"""
      SELECT c_name, c_custkey, o_orderkey, o_orderdate,
             o_totalprice/100.0, SUM(l_quantity)/100.0 AS quantity
      FROM customer, orders, lineitem
      WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem
                           GROUP BY l_orderkey
                           HAVING SUM(l_quantity) > {round(threshold * 100)})
        AND c_custkey = o_custkey AND o_orderkey = l_orderkey
      GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
      ORDER BY o_totalprice DESC, o_orderdate LIMIT 100"""


_PARAM_SQL[18] = _q18_sql

ORACLE_SQL.update({
    1: f"""
      SELECT l_returnflag, l_linestatus,
             SUM(l_quantity)/100.0 AS sum_qty,
             SUM(l_extendedprice)/100.0 AS sum_base_price,
             SUM(l_extendedprice * (100 - l_discount))/10000.0
               AS sum_disc_price,
             SUM(l_extendedprice * (100 - l_discount) * (100 + l_tax))
               /1000000.0 AS sum_charge,
             ((2 * SUM(l_quantity) + COUNT(*)) / (2 * COUNT(*)))/100.0
               AS avg_qty,
             ((2 * SUM(l_extendedprice) + COUNT(*)) / (2 * COUNT(*)))
               /100.0 AS avg_price,
             ((2 * SUM(l_discount) + COUNT(*)) / (2 * COUNT(*)))/100.0
               AS avg_disc,
             COUNT(*) AS count_order
      FROM lineitem
      WHERE l_shipdate <= {days('1998-09-02')}
      GROUP BY l_returnflag, l_linestatus
      ORDER BY l_returnflag, l_linestatus""",
    3: f"""
      SELECT l_orderkey,
             SUM(l_extendedprice * (100 - l_discount))/10000.0 AS revenue,
             o_orderdate, o_shippriority
      FROM customer, orders, lineitem
      WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
        AND l_orderkey = o_orderkey
        AND o_orderdate < {days('1995-03-15')}
        AND l_shipdate > {days('1995-03-15')}
      GROUP BY l_orderkey, o_orderdate, o_shippriority
      ORDER BY revenue DESC, o_orderdate LIMIT 10""",
    6: f"""
      SELECT SUM(l_extendedprice * l_discount)/10000.0 AS revenue
      FROM lineitem
      WHERE l_shipdate >= {days('1994-01-01')}
        AND l_shipdate < {days('1995-01-01')}
        AND l_discount BETWEEN 5 AND 7 AND l_quantity < 2400""",
    18: _q18_sql(),
})
